"""head_dim 256 in bf16 and f16 on the CPU: the plain blockwise forward
and backward at the tiles of the kernels that take those inputs on the
card (ops/flash_attention.py KERNEL_DOMAIN: the wgmma forward at
(128, 64), the wgmma dq at (128, 32), the split wgmma dk/dv at (64, 64))
against the JAX package's Pallas kernels in interpret mode, each run at
the same tiles: the forward at the forward's, its out and lse feeding
the backward at dq's tiles (dq) and at dk/dv's (dk, dv), as the port's
backward kernels take the forward's lse. So even a row that no key may
attend, whose output depends on the tiles that run, is compared like
with like. Then the domain and tile tables these kernels fix.

Tolerance: the reference's own for the 2-byte types, 3e-2 absolute and
relative (tests/test_flash_attention.py; both round P, dS and the
outputs, in another order in each framework). Under GQA the JAX kernels
take k/v repeated to every q head and write each head's dk/dv rounded to
the dtype; the group sum comes after. The plain version sums the group
in f32 and rounds once, as the port's kernels do. So dk/dv are held
relative to the size of the per-head terms the reference sums: where the
heads cancel, their roundings stay in the sum (a bf16 dv of -0.088 from
heads of +-2.4 to +-4.5 reads -0.125 there).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash_attention as jflash
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import flash_attention as tflash

TOL = 3e-2
JNP = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}
D256 = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv_split")

# b, lq, lk, h, hkv, causal, window, segments
CASES = {
    "causal-gqa4": (1, 256, 256, 8, 2, True, 0, False),
    "window": (1, 256, 256, 4, 1, True, 96, False),
    # lq > lk (end-aligned: the first 128 rows see no key) with distinct
    # q and kv segment ids, one q row's id held by no key: a row no key may
    # attend inside tiles that run (p = 1 there)
    "lq384-lk256-segments": (1, 384, 256, 4, 1, True, 0, True),
}


def _inputs(b, lq, lk, h, hkv, segments, seed=0):
    rng = np.random.default_rng(seed)
    draw = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    q, k, v = draw(b, lq, h, 256), draw(b, lk, hkv, 256), draw(b, lk, hkv, 256)
    g = draw(b, lq, h, 256)
    qseg = kseg = None
    if segments:
        kseg = np.cumsum(rng.random((b, lk)) < 4.0 / lk, axis=1).astype(np.int32)
        qseg = np.cumsum(rng.random((b, lq)) < 4.0 / lq, axis=1).astype(np.int32)
        qseg[:, 300] = 1000                  # no key holds this id
    return q, k, v, g, qseg, kseg


def _jax_at_tiles(dtype, q, k, v, g, qseg, kseg, causal, window):
    """(out, dq, dk, dv) of the JAX kernels, each at its port kernel's
    tiles, in [B, L, H, D] as f32 numpy."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]

    def bh(x):               # [B, L, H', D] -> [B*H, L, D], kv repeated
        x = jnp.repeat(jnp.asarray(x, JNP[dtype]), h // x.shape[2], axis=2)
        return x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d)

    def seg(x, n):
        return None if x is None else jnp.repeat(
            jnp.asarray(x)[:, None], h, axis=1).reshape(b * h, 1, n)

    jq, jk, jv, jg = bh(q), bh(k), bh(v), bh(g)
    segs = dict(qseg=seg(qseg, lq), kseg=seg(kseg, lk), window=window)
    scale = d ** -0.5
    fwd, dq_name, dkv = tflash.kernels_for(dtype, d)
    out, lse = jflash._flash_fwd(jq, jk, jv, scale, causal,
                                 *tflash.KERNEL_TILES[fwd][d], True, **segs)
    dq, _, _ = jflash._flash_bwd_pallas(
        jq, jk, jv, out, lse, jg, scale, causal,
        *tflash.KERNEL_TILES[dq_name][d], True, **segs)
    _, dk, dv = jflash._flash_bwd_pallas(
        jq, jk, jv, out, lse, jg, scale, causal,
        *tflash.KERNEL_TILES[dkv][d], True, **segs)

    def back(x, heads, n, group=1, fn=np.sum):
        """[B*H, L, D] -> [B, L, heads, D], fn over each group of heads"""
        x = np.asarray(x, np.float32).reshape(b, heads, group, n, d)
        return fn(x, axis=2).transpose(0, 2, 1, 3)

    def terms(x):            # the size of the per-head terms of a group sum
        return back(x, hkv, lk, h // hkv, lambda y, axis: np.abs(y).sum(axis))

    return ((back(out, h, lq), back(dq, h, lq), back(dk, hkv, lk, h // hkv),
             back(dv, hkv, lk, h // hkv)),
            (None, None, terms(dk), terms(dv)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_at_d256_tiles_matches_jax(name, dtype):
    b, lq, lk, h, hkv, causal, window, segments = CASES[name]
    q, k, v, g, qseg, kseg = _inputs(b, lq, lk, h, hkv, segments)
    fwd, dq_name, dkv = tflash.kernels_for(dtype, 256)
    tq, tk, tv, tg = (torch.tensor(x).to(dtype) for x in (q, k, v, g))
    tqs = None if qseg is None else torch.tensor(qseg)
    tks = None if kseg is None else torch.tensor(kseg)
    cfg = dict(scale=256 ** -0.5, causal=causal, window=window)
    out, lse = tflash.flash_fwd_plain(tq, tk, tv, tqs, tks, **cfg,
                                      **tflash.kernel_blocks(fwd, 256))
    dq, _, _ = tflash.flash_bwd_plain(tq, tk, tv, out, lse, tg, tqs, tks,
                                      **cfg,
                                      **tflash.kernel_blocks(dq_name, 256))
    _, dk, dv = tflash.flash_bwd_plain(tq, tk, tv, out, lse, tg, tqs, tks,
                                       **cfg, **tflash.kernel_blocks(dkv, 256))
    if segments:             # the row no key may attend is in the case
        assert lse[0, 0, 300] == torch.tensor(tflash.NEG_INF)
    want, size = _jax_at_tiles(dtype, q, k, v, g, qseg, kseg, causal,
                               window)
    for got, w, m, n in zip((out, dq, dk, dv), want, size,
                            ("out", "dq", "dk", "dv")):
        assert got.dtype == dtype, n
        got = got.float().numpy()
        if m is None:
            np.testing.assert_allclose(got, w, atol=TOL, rtol=TOL,
                                       err_msg=f"{n} ({name})")
        else:
            excess = np.abs(got - w) - (TOL + TOL * m)
            assert excess.max() <= 0, (n, name, float(excess.max()))


def test_d256_domain_names_the_wgmma_kernels():
    """bf16 and f16 at head_dim 256: the wgmma forward and dq and the
    split wgmma dk/dv; f32 stays on the SIMT kernels."""
    for dtype in (torch.bfloat16, torch.float16):
        assert tflash.kernels_for(dtype, 256) == D256 == tflash.SM90_D256
    assert tflash.kernels_for(torch.float32, 256) == tflash.SIMPLE
    for dtype in (torch.bfloat16, torch.float16):
        for d in (64, 128):
            assert tflash.kernels_for(dtype, d) == tflash.SM90
    assert set(tflash.LAUNCHES) == set(tflash.SM90 + tflash.SIMPLE + D256)


def test_d256_tiles_keep_the_reference_lengths():
    """No tile passes 128 rows or keys, so the kernels take every length
    the reference's rule does (multiples of 128)."""
    assert tflash.KERNEL_LENGTH == 128
    assert tflash.KERNEL_TILES["flash_fwd"][256] == (128, 64)
    assert tflash.KERNEL_TILES["flash_bwd_dq"][256] == (128, 32)
    # the f32 SIMT kernels take 64 x 64 tiles at every head dim: the
    # forward, and dq and dk/dv, whose stationary tiles leave room for 64
    # rows at 256 because they stream K (or Q and dO) twice
    for name in tflash.SIMPLE:
        assert tflash.KERNEL_TILES[name] == {
            64: (64, 64), 128: (64, 64), 256: (64, 64)}, name
    assert tflash.KERNEL_TILES["flash_bwd_dkv_split"] == {256: (64, 64)}
    # the D 64/128 wgmma tiles are as before
    assert tflash.KERNEL_TILES["flash_fwd"][64] == (128, 128)
    assert tflash.KERNEL_TILES["flash_fwd"][128] == (128, 128)


def test_d256_kernels_have_sources_and_launchers():
    """Each kernel of the D256 triple has a source that `_build` compiles
    and a C launcher with a signature; the split dk/dv's launcher takes
    the dk/dv kernels' arguments."""
    for name in D256:
        src, fn = tflash._LAUNCHERS[name]
        assert src in _build.SOURCES and (_build.CSRC / src).is_file()
        assert fn in _build.SIGNATURES
        assert f'int {fn}(' in (_build.CSRC / src).read_text()
    assert (_build.SIGNATURES["kft_flash_bwd_dkv_split"]
            == _build.SIGNATURES["kft_flash_bwd_dkv"])


def test_simt_source_keeps_only_dq_at_two_byte_d256():
    """flash_simple.cu instantiates f32 alone: each of its three
    launchers goes through the one domain, f32 at head_dim 64, 128 and
    256, and no 2-byte type is named (the D256 dq moved to the wgmma
    kernel of flash_bwd.cu)."""
    text = (_build.CSRC / "flash_simple.cu").read_text()
    calls = re.findall(r"on_domain\(elem, D, .*?launch\("
                       r"(flash_simple_\w+)_kernel", text, re.S)
    assert sorted(calls) == ["flash_simple_bwd_dkv", "flash_simple_bwd_dq",
                             "flash_simple_fwd"]
    domain = re.search(r"static cudaError_t on_domain\(.*?\n}", text,
                       re.S).group(0)
    assert re.findall(r"fn\(Dim<(\d+)>\{\}, (\w+)\{\}\)", domain) == [
        ("64", "float"), ("128", "float"), ("256", "float")]
    for two_byte in ("bf16", "f16", "__nv_bfloat16", "__half"):
        assert not re.search(rf"\b{two_byte}\b", text), two_byte


def test_ptxas_report_names_the_split_kernel(tmp_path):
    """The build log's entries parse to (kernel, (type, head_dim)), the
    split dk/dv and the D256 forward among them."""
    log = tmp_path / "flash_bwd_dkv_split-0.log"
    log.write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN3kft4sm9026flash_bwd_dkv_split_kernelILi256E13__nv_bfloat16EEv"
        "14CUtensorMap_stS3_S3_S3_NS0_4ArgsE' for 'sm_90a'\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Compiling entry function "
        "'_ZN3kft4sm9016flash_fwd_kernelILi256E6__halfEEv14CUtensorMap_stS3_"
        "S3_NS0_4ArgsE' for 'sm_90a'\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Compiling entry function "
        "'_ZN3kft4sm9019flash_bwd_dq_kernelILi256E13__nv_bfloat16EEv14CUtens"
        "orMap_stS3_S3_S3_NS0_4ArgsE' for 'sm_90a'\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n")
    got = _build.ptxas_report({"x": log.with_suffix(".so")})
    assert got == {
        "flash_bwd_dkv_split": {("bf16", 256): {"registers": 168,
                                                "spill_bytes": 0}},
        "flash_fwd": {("f16", 256): {"registers": 168, "spill_bytes": 16}},
        "flash_bwd_dq": {("bf16", 256): {"registers": 168,
                                         "spill_bytes": 0}}}


def test_planted_faults_and_ablations_match_their_sources():
    """Each planted fault of mutation_check and each ablation of
    kernel_ablation is one text substitution that must match its source
    exactly once (the card run raises otherwise); the faults that must
    fail in the head_dim 256 cases are faults, and reach the sources of
    every kernel that takes head_dim 256 in a wgmma form (the forward,
    dq, the split dk/dv) and the f32 kernels' streams of stages; each f32
    backward kernel has ablations of its products and its exp."""
    from kubeflow_tpu_torch import kernel_ablation, mutation_check

    edits = {**mutation_check.FAULTS,
             **{n: e for n, (_, e) in kernel_ablation.ABLATIONS.items()}}
    for name, (fname, old, new) in edits.items():
        assert (_build.CSRC / fname).read_text().count(old) == 1, name
        assert old != new, name
    assert set(mutation_check.MUST_CATCH) <= set(mutation_check.FAULTS)
    assert {mutation_check.FAULTS[n][0] for n in mutation_check.MUST_CATCH} \
        == {"flash_fwd.cu", "flash_bwd.cu", "flash_bwd_dkv_split.cu",
            "flash_simple.cu"}
    assert {mutation_check.MUST_CATCH[n] for n in (
        "dq_skips_last_k_tile", "dq_ds_without_delta")} == {"bfloat16/256"}
    assert (torch.bfloat16, 256) in mutation_check.SHAPES
    assert (torch.float32, 256) in mutation_check.SHAPES
    assert {mutation_check.MUST_CATCH[n] for n in (
        "simple_fwd_stage_one_off", "simple_dq_second_k_pass_stale_stage",
        "simple_dkv_dv_fed_q_chunks")} == {"float32/256"}
    for kernel in ("flash_simple_bwd_dq", "flash_simple_bwd_dkv"):
        parts = {n.split("_no_")[1] for n, (k, _) in
                 kernel_ablation.ABLATIONS.items() if k == kernel}
        assert len(parts) == 3 and "exp" in parts, (kernel, parts)
