"""The port's CUDA flash kernels against their plain versions, on the card,
and the Prefetcher's side-stream copies there.

Marked `cuda`: each test skips when torch sees no GPU (decided inside the
fixture, never at import). Run on an H100 with
    python -m pytest tests/test_torch_kernels_cuda.py -q
Tolerance: that of chip_smoke.py (`kubeflow_tpu_torch/ops/kernel_check.py`):
each row's L2 error within 1e-2 of the row's L2 norm (2e-2 for dq),
lse within 1e-3 absolute plus 1e-3 relative.
"""

import pytest
import torch

from kubeflow_tpu_torch.ops import attention as attn
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.ops import kernel_check
from kubeflow_tpu_torch.ops.xent import head_logits, head_logits_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, b, lq, lk, h, hkv, d, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(dtype)  # noqa: E731
    return mk(b, lq, h, d), mk(b, lk, hkv, d), mk(b, lk, hkv, d), mk(b, lq, h, d)


def _segs(dev, b, l, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    cuts = torch.rand(b, l, device=dev, generator=g) < 4.0 / l
    return torch.cumsum(cuts.int(), dim=1).to(torch.int32).contiguous()


CASES = [
    # b, lq, lk, h, hkv, d, causal, window, segments
    (2, 256, 256, 4, 4, 64, True, 0, False),
    (2, 256, 256, 4, 2, 64, False, 0, False),
    (1, 128, 384, 4, 1, 64, True, 0, False),
    (1, 384, 128, 2, 2, 64, True, 0, False),
    (2, 512, 512, 4, 2, 64, True, 96, False),
    (2, 256, 256, 4, 2, 64, False, 64, False),
    (2, 256, 256, 4, 2, 64, True, 0, True),
    (1, 256, 256, 4, 4, 128, True, 0, False),
    (1, 256, 256, 2, 1, 128, True, 80, True),
    # at the edges of the 128-row and 128-key tiles: an odd number of
    # tiles; lq > lk and lq < lk by one and two tiles (rows that see no
    # key); windows that are not a multiple of the tile; GQA groups of 1,
    # 4 and 8; head_dim 128 with segments; a key length of one tile, so
    # the k/v ring is deeper than the tiles a CTA walks
    (2, 384, 384, 4, 2, 64, True, 0, False),
    (1, 384, 384, 2, 1, 128, False, 0, False),
    (1, 384, 256, 4, 2, 64, True, 0, False),
    (1, 512, 256, 4, 2, 64, True, 0, False),
    (1, 256, 384, 4, 2, 64, True, 0, False),
    (1, 256, 512, 4, 2, 128, True, 0, False),
    (2, 512, 512, 4, 2, 64, True, 200, False),
    (1, 384, 512, 4, 1, 64, True, 96, False),
    (1, 512, 512, 2, 2, 64, False, 200, False),
    (2, 256, 256, 4, 1, 64, True, 0, False),
    (1, 384, 384, 8, 1, 64, True, 0, True),
    (2, 384, 384, 4, 2, 128, True, 0, True),
    (2, 128, 128, 4, 2, 64, True, 0, False),
    (1, 512, 128, 4, 1, 128, False, 0, False),
    (1, 128, 128, 8, 1, 64, True, 64, True),
    # at the edges of dq's 64-key tile at head_dim 128: a key length of
    # two such tiles, lq > lk and lq < lk by two of them (rows that see
    # no key), windows of 1.5 and 3.5 of them, GQA 8 with segments
    (1, 128, 128, 4, 2, 128, True, 0, False),
    (1, 256, 128, 4, 2, 128, True, 0, False),
    (2, 256, 384, 4, 1, 128, True, 0, False),
    (2, 256, 256, 4, 2, 128, True, 96, False),
    (1, 384, 384, 2, 2, 128, False, 224, False),
    (1, 256, 256, 8, 1, 128, True, 0, True),
    # lq != lk with distinct q and kv segment ids: rows no key may attend
    # inside tiles that run (their masked logits give p = 1)
    (1, 384, 256, 4, 2, 64, True, 0, True),
    (1, 384, 256, 4, 1, 128, True, 96, True),
    (2, 256, 512, 4, 2, 64, True, 0, True),
    # head_dim 128 at the main path's full shape (llama-1b widths: 16
    # heads of 128, 4 kv heads, batch 8, seq 2048)
    (8, 2048, 2048, 16, 4, 128, True, 0, False),
    # the entry() forward's shape (gpt-125m: 12 q heads = 12 kv heads)
    (2, 256, 256, 12, 12, 64, True, 0, False),
]


# The rest of the reference's domain (ops/flash_attention.py
# KERNEL_DOMAIN): f16 on the wgmma kernels at head_dim 64 and 128; f32 at
# 64, 128 and 256 on the SIMT kernels of flash_simple.cu, at the edges of
# their 64-row and 64-key tiles; bf16/f16 at 256 on the wgmma forward
# (128-row, 64-key tiles), the wgmma dq (128-row, 32-key tiles) and the
# split wgmma dk/dv (64 x 64).
DOMAIN_CASES = [
    # dtype, b, lq, lk, h, hkv, d, causal, window, segments
    (torch.float16, 2, 256, 256, 4, 2, 64, True, 0, False),
    (torch.float16, 1, 384, 256, 4, 1, 128, True, 96, True),
    (torch.float16, 1, 256, 384, 4, 2, 64, False, 0, True),
    (torch.float32, 2, 256, 256, 4, 2, 64, True, 0, False),
    (torch.float32, 1, 128, 384, 4, 2, 64, True, 0, True),
    (torch.float32, 1, 384, 128, 2, 2, 128, True, 80, False),
    (torch.float32, 1, 256, 256, 4, 1, 128, False, 0, True),
    (torch.float32, 1, 256, 256, 4, 1, 256, False, 0, False),
    (torch.float32, 2, 256, 256, 4, 2, 256, True, 96, True),
    (torch.bfloat16, 2, 256, 256, 4, 2, 256, True, 0, False),
    (torch.bfloat16, 1, 384, 512, 4, 1, 256, True, 200, True),
    (torch.float16, 1, 256, 256, 2, 2, 256, False, 64, False),
    (torch.float16, 1, 512, 256, 8, 2, 256, True, 0, False),
    # rank 1 of a seq-2 world at llama-1b widths: its q block against the
    # gathered key prefix (end-aligned offset = the block's start)
    (torch.float32, 1, 1024, 2048, 32, 8, 64, True, 0, False),
    # head_dim 256 in bf16 and f16 at the edges of the D256 tiles: one
    # 128-row q tile (one item of the persistent forward, two 64-key
    # tiles), lq > lk and lq < lk by one and two tiles with distinct q and
    # kv segment ids (rows no key may attend inside tiles that run),
    # windows that are not a multiple of 64, GQA groups of 1, 2, 4 and 8,
    # non-causal, and the kernel phase's full shape
    (torch.bfloat16, 1, 128, 128, 4, 1, 256, True, 0, False),
    (torch.float16, 1, 128, 128, 8, 1, 256, True, 64, True),
    (torch.bfloat16, 1, 384, 256, 4, 2, 256, True, 0, True),
    (torch.float16, 1, 384, 256, 4, 1, 256, True, 96, True),
    (torch.bfloat16, 1, 256, 384, 8, 2, 256, True, 96, True),
    (torch.float16, 2, 128, 384, 4, 2, 256, True, 0, False),
    (torch.bfloat16, 2, 384, 384, 4, 4, 256, False, 0, False),
    (torch.float16, 1, 384, 384, 2, 2, 256, False, 200, True),
    (torch.bfloat16, 1, 512, 128, 4, 1, 256, True, 0, False),
    (torch.float16, 2, 256, 256, 4, 1, 256, True, 200, False),
    (torch.bfloat16, 8, 2048, 2048, 8, 2, 256, True, 0, False),
    (torch.float16, 8, 2048, 2048, 8, 2, 256, True, 0, True),
    # the D256 wgmma dq's 32-key tiles and single Q/dO buffer: windows
    # that are not a multiple of 32, lq > lk and lq < lk with distinct q
    # and kv segment ids, a CTA that walks several items (batch 4 x 8
    # heads x 3 q tiles on a grid of one CTA per SM), non-causal
    (torch.bfloat16, 1, 256, 384, 4, 1, 256, True, 40, True),
    (torch.float16, 2, 384, 128, 4, 2, 256, True, 0, True),
    (torch.bfloat16, 1, 128, 256, 8, 2, 256, False, 72, False),
    (torch.float16, 4, 384, 384, 8, 8, 256, True, 0, False),
    # the f32 forward's 64 x 64 tiles at every head dim and its stream of
    # K/V chunks through the ring: one tile (a stream shorter than the
    # ring), lq > lk and lq < lk with distinct q and kv segment ids,
    # windows that are not a multiple of 64, non-causal, GQA 4
    (torch.float32, 1, 128, 128, 2, 1, 64, True, 0, False),
    (torch.float32, 1, 384, 256, 4, 2, 256, True, 0, True),
    (torch.float32, 1, 128, 512, 4, 1, 256, True, 200, False),
    (torch.float32, 2, 256, 256, 8, 2, 128, True, 40, True),
    (torch.float32, 1, 512, 384, 4, 4, 64, False, 100, True),
    (torch.float32, 1, 256, 256, 2, 2, 256, False, 0, False),
    # the f32 backward's 64 x 64 tiles and its streams (dq: V's and K's
    # chunks, then K's again; dk/dv: Q's and dO's, then both again): q and
    # k tiles that walk one or two tiles, and k tiles no q tile sees
    # (streams shorter than the ring, or empty), lq > lk and lq < lk with
    # distinct q and kv segment ids (rows no key may attend inside tiles
    # that run), windows of 40 and 200, GQA groups of 1, 4 and 8,
    # non-causal, and the kernel phase's full head_dim 256 shape
    (torch.float32, 1, 128, 128, 4, 4, 256, True, 0, False),
    (torch.float32, 1, 128, 512, 8, 1, 256, True, 64, False),
    (torch.float32, 1, 384, 256, 8, 2, 128, True, 40, True),
    (torch.float32, 1, 256, 384, 4, 1, 256, True, 200, True),
    (torch.float32, 2, 256, 256, 8, 8, 64, False, 0, True),
    (torch.float32, 1, 256, 512, 8, 1, 128, False, 200, False),
    (torch.float32, 1, 384, 128, 4, 1, 64, True, 0, True),
    (torch.float32, 8, 2048, 2048, 8, 2, 256, True, 0, False),
]


@pytest.mark.parametrize("case", DOMAIN_CASES,
                         ids=lambda c: "-".join(map(str, c)).replace(
                             "torch.", ""))
def test_domain_kernels_match_plain(dev, case):
    dtype, b, lq, lk, h, hkv, d, causal, window, segments = case
    q, k, v, dout = _inputs(dev, b, lq, lk, h, hkv, d, dtype=dtype)
    qseg = kseg = None
    if segments:
        qseg = _segs(dev, b, lq)
        kseg = qseg if lq == lk else _segs(dev, b, lk)
    errs = kernel_check.flash_errors(q, k, v, dout, qseg, kseg,
                                     scale=d ** -0.5, causal=causal,
                                     window=window)
    assert not kernel_check.failures(errs, dtype), errs


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernels_match_plain(dev, case):
    b, lq, lk, h, hkv, d, causal, window, segments = case
    q, k, v, dout = _inputs(dev, b, lq, lk, h, hkv, d)
    qseg = kseg = None
    if segments:
        qseg = _segs(dev, b, lq)
        kseg = qseg if lq == lk else _segs(dev, b, lk)
    errs = kernel_check.flash_errors(q, k, v, dout, qseg, kseg,
                                     scale=d ** -0.5, causal=causal,
                                     window=window)
    assert not kernel_check.failures(errs, torch.bfloat16), errs


def test_autograd_reaches_kernels(dev):
    q, k, v, dout = _inputs(dev, 1, 128, 128, 4, 2, 64)
    q.requires_grad_()
    before = dict(fa.LAUNCHES)
    fa.flash_attention(q, k, v).backward(dout)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        **dict.fromkeys(fa.LAUNCHES, 0),
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_autograd_reaches_d256_kernels(dev, dtype):
    """head_dim 256 in a 2-byte type: one forward and backward launch the
    wgmma forward, the wgmma dq and the split wgmma dk/dv once each, by
    name and by instantiation, and nothing else."""
    q, k, v, dout = _inputs(dev, 1, 256, 256, 4, 1, 256, dtype=dtype)
    q.requires_grad_()
    fa.reset_launches()
    fa.flash_attention(q, k, v).backward(dout)
    torch.cuda.synchronize()
    assert dict(fa.LAUNCHES) == {
        **dict.fromkeys(fa.LAUNCHES, 0),
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv_split": 1}
    assert fa.INSTANCE_LAUNCHES == {
        f"flash_fwd[{str(dtype)[6:]}/256]": 1,
        f"flash_bwd_dq[{str(dtype)[6:]}/256]": 1,
        f"flash_bwd_dkv_split[{str(dtype)[6:]}/256]": 1}


def test_kernel_rejects_unsupported_input(dev):
    q, k, v, _ = _inputs(dev, 1, 100, 100, 2, 2, 64)
    with pytest.raises(ValueError):
        fa.flash_fwd_cuda(q, k, v, scale=0.125, causal=True)
    q, k, v, _ = _inputs(dev, 1, 128, 128, 2, 2, 64)
    with pytest.raises(ValueError):          # no kernel takes f64
        fa.flash_fwd_cuda(q.double(), k.double(), v.double(), scale=0.125,
                          causal=True)
    with pytest.raises(ValueError):          # nor mixed dtypes
        fa.flash_fwd_cuda(q, k.float(), v, scale=0.125, causal=True)


def test_auto_raises_for_shapes_the_kernel_lacks(dev):
    """No shape the reference sends to its flash kernel is left: `auto`
    launches a kernel for f32 and f16 at head_dim 64 and bf16 at 256,
    never raising and never taking the plain path, and agrees with the
    reference attention."""
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 256),
                     (torch.float16, 64)):
        q, k, v, _ = _inputs(dev, 1, 128, 128, 2, 2, d, dtype=dtype)
        fa.reset_launches()
        got = attn.attention(q, k, v, impl="auto")
        torch.cuda.synchronize()
        fwd = fa.kernels_for(dtype, d)[0]
        assert sum(fa.LAUNCHES.values()) == fa.LAUNCHES[fwd] == 1, (dtype, d)
        assert fa.INSTANCE_LAUNCHES == {fa.instance_name(fwd, dtype, d): 1}
        want = attn.attention(q, k, v, impl="reference")
        e = kernel_check.errors(got, want)
        assert e["max_row_err"] <= kernel_check.row_tol(dtype), (dtype, d, e)


def test_head_product_matches_plain_formula(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, 64, 256, device=dev, generator=g).to(torch.bfloat16)
    w = torch.randn(256, 1000, device=dev, generator=g) * 0.05
    cot = torch.randn(2, 64, 1000, device=dev, generator=g)
    got = {}
    for name, fn in (("card", head_logits), ("plain", head_logits_plain)):
        xi, wi = x.detach().requires_grad_(), w.detach().requires_grad_()
        out = fn(xi, wi, torch.bfloat16)
        out.backward(cot)
        got[name] = (out.detach(), xi.grad, wi.grad)
    for what, a, b in zip(("logits", "dx", "dkernel"), got["card"],
                          got["plain"]):
        assert a.dtype == b.dtype, what
        e = kernel_check.errors(a, b)
        assert e["max_row_err"] <= kernel_check.ROW_TOL, (what, e)


def test_block_sizes_are_ignored_on_card_with_a_warning(dev):
    q, k, v, _ = _inputs(dev, 1, 256, 256, 2, 2, 64)
    with pytest.warns(UserWarning, match="ignored"):
        got = fa.flash_attention(q, k, v, block_q=128, block_k=256)
    torch.testing.assert_close(got, fa.flash_attention(q, k, v), atol=0,
                               rtol=0)


def test_custom_ops_launch_the_kernels(dev, monkeypatch):
    """kftpu::flash_fwd / flash_bwd on CUDA tensors launch the CUDA
    kernels and never the plain version."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fa, "flash_fwd_plain", plain)
    monkeypatch.setattr(fa, "flash_bwd_plain", plain)
    q, k, v, dout = _inputs(dev, 1, 256, 256, 4, 2, 64)
    before = dict(fa.LAUNCHES)
    out, lse = torch.ops.kftpu.flash_fwd(q, k, v, None, None, 0.125, True,
                                         512, 512, 0)
    torch.ops.kftpu.flash_bwd(q, k, v, out, lse, dout, None, None, 0.125,
                              True, 512, 512, 0)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        **dict.fromkeys(fa.LAUNCHES, 0),
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    with pytest.raises(ValueError):          # shapes the kernel lacks raise
        torch.ops.kftpu.flash_fwd(q[:, :100], k[:, :100], v[:, :100], None,
                                  None, 0.125, True, 512, 512, 0)


@pytest.mark.parametrize("policy,fwd_per_layer", [
    ("slim", 1), ("dots", 1), ("mlp", 1), ("full", 2)])
def test_remat_step_launches(dev, policy, fwd_per_layer):
    """A 2-layer bf16 step at head_dim 64: the flash forward launches once
    per layer, twice under full remat, which replays it; each backward
    kernel once per layer."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops.xent import chunked_lm_xent

    model = get_model("transformer-test", device=dev, d_model=256,
                      n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                      remat=True, remat_policy=policy)
    tok = torch.randint(0, 256, (2, 256), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    fa.reset_launches()
    hidden = model(tok, return_hidden=True)
    loss, _ = chunked_lm_xent(hidden, model.lm_head.kernel, tok.roll(-1, 1),
                              2, compute_dtype=model.cfg.dtype)
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert dict(fa.LAUNCHES) == {**dict.fromkeys(fa.LAUNCHES, 0),
                                 "flash_fwd": 2 * fwd_per_layer,
                                 "flash_bwd_dq": 2, "flash_bwd_dkv": 2}


def test_prefetcher_copies_on_a_side_stream(dev):
    """Batches copied on the Prefetcher's stream equal their host arrays
    when the compute stream reads them, with later copies in flight."""
    import numpy as np

    from kubeflow_tpu_torch.runtime.data import Prefetcher

    rng = np.random.default_rng(0)
    host = [{"tokens": rng.integers(0, 32000, (8, 2048), dtype=np.int32)}
            for _ in range(6)]
    pf = Prefetcher(iter(host), dev)
    try:
        for want in host:
            got = next(pf)["tokens"]
            assert got.device.type == "cuda" and got.dtype == torch.int32
            assert int((got.long() * 2).sum()) == int(
                want["tokens"].astype(np.int64).sum() * 2)
            del got              # freed while the next copies run
        with pytest.raises(StopIteration):
            next(pf)
    finally:
        pf.close()


def test_resnet50_one_step_on_the_card_equals_the_cpu(dev):
    """chip_smoke's phase 18 outside it: ResNet-50 at full width and
    depth, batch 8, 224px, the same weights on the card and the CPU, f32
    with TF32 off. After one sgdm step the eval-mode logits and every
    BatchNorm statistic agree within 1e-3 relative, every parameter
    within 1e-2 per row (kernel_check's limit)."""
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    cfg = TrainConfig.from_dict({
        "model": "resnet50", "task": "classification", "global_batch": 8,
        "image_size": 224, "optimizer": "sgdm", "learning_rate": 0.1,
        "warmup_steps": 0, "total_steps": 10,
        "model_kwargs": {"stem": "space_to_depth", "dtype": "float32"}})
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = Trainer(cfg, device="cpu")
        card = Trainer(cfg, device=dev)
        card.model.load_state_dict(cpu.model.state_dict())
        host = next(cpu.data_iter())
        out = {}
        for tag, t in (("cpu", cpu), ("card", card)):
            batch = t._to_device(host)
            t.train_step(batch)
            t.model.eval()
            with torch.no_grad():
                logits = t.model(batch["image"]).float().cpu()
            out[tag] = (logits, {k: v.float().cpu() for k, v in
                                 t.model.state_dict().items()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (want, want_sd), (got, got_sd) = out["cpu"], out["card"]
    for g, w in zip(got, want):
        assert float((g - w).norm() / w.norm()) <= 1e-3
    params = {n for n, _ in cpu.model.named_parameters()}
    for name, w in want_sd.items():
        g = got_sd[name]
        if name in params:
            rows = (lambda t: t.reshape(t.shape[0], -1) if t.ndim > 1
                    else t[None])
            err = kernel_check.errors(rows(g), rows(w))["max_row_err"]
            assert err <= kernel_check.ROW_TOL, name
        else:
            assert float((g - w).norm() / w.norm()) <= 1e-3, name
