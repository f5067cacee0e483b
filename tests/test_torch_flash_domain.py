"""The rest of the flash kernels' domain on the CPU: the port's plain
blockwise forward and backward (what the CUDA kernels are held to on the
card) at f32, f16 and head_dim 256, each at the tiles of the kernel that
takes it (ops/flash_attention.py KERNEL_DOMAIN, KERNEL_TILES), against
the JAX package's flash kernel in interpret mode on the same numpy
inputs.

Tolerances are tests/test_torch_flash_attention.py's for the dtype (the
reference's own, tests/test_flash_attention.py): f32 forward 2e-5 and
gradients 5e-4; f16 and bf16 3e-2 (the 2-byte types round P, dS and the
outputs, in another order in each framework).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash_attention as jflash
from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops import flash_attention as tflash

TOL = {torch.float32: (2e-5, 5e-4), torch.float16: (3e-2, 3e-2),
       torch.bfloat16: (3e-2, 3e-2)}
JNP = {torch.float32: jnp.float32, torch.float16: jnp.float16,
       torch.bfloat16: jnp.bfloat16}

# dtype, b, lq, lk, h, hkv, d, causal, window, segments (False, True:
# the keys' ids end-aligned to the rows, or "distinct": ids drawn apart for
# rows and keys, one row's id held by no key)
CASES = {
    "f32-d256-causal": (torch.float32, 1, 128, 128, 2, 1, 256, True, 0, False),
    "f32-d256-window-segments": (torch.float32, 1, 256, 256, 2, 2, 256, True,
                                 96, True),
    "f32-d128-noncausal-gqa": (torch.float32, 1, 128, 256, 4, 2, 128, False,
                               0, False),
    # the f32 forward's 64 x 64 tiles at head_dim 64, and at 256 with lq <
    # lk under a window that is not a multiple of 64
    "f32-d64-causal-gqa": (torch.float32, 2, 256, 256, 4, 2, 64, True, 0,
                           False),
    "f32-d256-lq128-lk256-window": (torch.float32, 1, 128, 256, 2, 1, 256,
                                    True, 80, False),
    # the f32 backward's 64 x 64 tiles at every head dim: one q tile, and
    # one k tile; lq != lk with distinct q and kv ids (rows no key may
    # attend, inside tiles that run); windows that are not a multiple of
    # 64; GQA 4
    "f32-d64-lq64-lk192-distinct-gqa4": (torch.float32, 1, 64, 192, 4, 1,
                                         64, True, 0, "distinct"),
    "f32-d128-lq192-lk64-window-distinct": (torch.float32, 1, 192, 64, 2, 2,
                                            128, True, 40, "distinct"),
    "f32-d256-lq128-lk192-window-distinct-gqa4": (
        torch.float32, 1, 128, 192, 4, 1, 256, True, 100, "distinct"),
    "f16-d64-causal-gqa": (torch.float16, 2, 128, 128, 4, 2, 64, True, 0,
                           False),
    "f16-d256-window": (torch.float16, 1, 256, 256, 2, 1, 256, True, 64,
                        False),
    "bf16-d256-segments": (torch.bfloat16, 1, 128, 256, 2, 1, 256, True, 0,
                           True),
}


def _inputs(b, lq, lk, h, hkv, d, segments, seed=0):
    rng = np.random.default_rng(seed)
    draw = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    q, k, v, g = draw(b, lq, h, d), draw(b, lk, hkv, d), draw(b, lk, hkv, d), \
        draw(b, lq, h, d)
    qseg = kseg = None
    if segments:
        kseg = np.cumsum(rng.random((b, lk)) < 3.0 / lk, axis=1).astype(np.int32)
        qseg = kseg[:, lk - lq:]          # end-aligned with the keys
    if segments == "distinct":
        qseg = np.cumsum(rng.random((b, lq)) < 3.0 / lq, axis=1).astype(np.int32)
        qseg[:, lq // 2] = 1000           # no key holds this id
    return q, k, v, g, qseg, kseg


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_at_kernel_tiles_matches_jax(name):
    dtype, b, lq, lk, h, hkv, d, causal, window, segments = CASES[name]
    q, k, v, g, qseg, kseg = _inputs(b, lq, lk, h, hkv, d, segments)
    fwd, dq_name, dkv = tflash.kernels_for(dtype, d)
    jseg = {} if qseg is None else dict(segment_ids=jnp.asarray(qseg),
                                        kv_segment_ids=jnp.asarray(kseg))
    tq, tk, tv, tg = (torch.tensor(x).to(dtype) for x in (q, k, v, g))
    tqs = None if qseg is None else torch.tensor(qseg)
    tks = None if kseg is None else torch.tensor(kseg)
    cfg = dict(scale=d ** -0.5, causal=causal, window=window)
    out, lse = tflash.flash_fwd_plain(tq, tk, tv, tqs, tks, **cfg,
                                      **tflash.kernel_blocks(fwd, d))
    dq, _, _ = tflash.flash_bwd_plain(tq, tk, tv, out, lse, tg, tqs, tks,
                                      **cfg, **tflash.kernel_blocks(dq_name, d))
    _, dk, dv = tflash.flash_bwd_plain(tq, tk, tv, out, lse, tg, tqs, tks,
                                       **cfg, **tflash.kernel_blocks(dkv, d))
    assert out.dtype == dq.dtype == dk.dtype == dtype
    # the reference at the forward kernel's blocks (its backward shares
    # them). Blocking moves only a row no key may attend (it averages the
    # keys of the blocks that ran): the other cases have none, and in the
    # distinct-id cases all three kernels tile alike, as the reference
    bq, bk = tflash.KERNEL_TILES[fwd][d]
    if segments == "distinct":
        assert lse[0, 0, lq // 2] == torch.tensor(tflash.NEG_INF)
        assert {tflash.KERNEL_TILES[n][d] for n in (fwd, dq_name, dkv)} == {
            (bq, bk)}

    def f(q, k, v):
        return jflash.flash_attention(q, k, v, causal=causal, block_q=bq,
                                      block_k=bk, window=window, **jseg)

    import jax

    jq, jk, jv = (jnp.asarray(x, JNP[dtype]) for x in (q, k, v))
    jout, vjp = jax.vjp(f, jq, jk, jv)
    want = [np.asarray(x, np.float32)
            for x in (jout, *vjp(jnp.asarray(g, JNP[dtype])))]
    fwd_tol, grad_tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), want[0], atol=fwd_tol,
                               rtol=fwd_tol, err_msg=f"out ({name})")
    for got, w, n in zip((dq, dk, dv), want[1:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.float().numpy(), w, atol=grad_tol,
                                   rtol=grad_tol, err_msg=f"{n} ({name})")


def test_auto_dispatch_covers_the_domain_on_cpu():
    """On the CPU `auto` takes the plain reference path for every dtype
    (nothing launches); `flash` takes the plain flash version at any
    head dim, equal to the reference within the dtype's tolerance."""
    tflash.reset_launches()
    for dtype in (torch.float32, torch.float16):
        q, k, v, _, _, _ = _inputs(1, 128, 128, 2, 2, 256, False)
        tq, tk, tv = (torch.tensor(x).to(dtype) for x in (q, k, v))
        ref = tattn.attention(tq, tk, tv, impl="auto")
        torch.testing.assert_close(
            ref, tattn.reference_attention(tq, tk, tv), rtol=0, atol=0)
        flash = tattn.attention(tq, tk, tv, impl="flash")
        tol = TOL[dtype][0] if dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(flash.float().numpy(),
                                   ref.float().numpy(), atol=tol, rtol=tol)
    assert set(tflash.LAUNCHES.values()) == {0}
    assert not tflash.INSTANCE_LAUNCHES
