"""The port's flash attention (plain blockwise fwd/bwd, on the CPU) and
reference attention against the JAX package's, on the same numpy inputs.

JAX flash runs its Pallas kernels in interpret mode on the CPU, as in
tests/test_flash_attention.py, whose tolerances these are: forward f32
2e-5, gradients 5e-4, bf16 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import attention as jattn
from kubeflow_tpu.ops import flash_attention as jflash
from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops import flash_attention as tflash


def _inputs(b, lq, lk, h, hk, d, seed=0, segments=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, lk, hk, d), dtype=np.float32)
    v = rng.standard_normal((b, lk, hk, d), dtype=np.float32)
    g = rng.standard_normal((b, lq, h, d), dtype=np.float32)
    seg = None
    if segments:
        seg = np.cumsum(rng.random((b, lq)) < 3.0 / lq, axis=1).astype(np.int32)
    return q, k, v, g, seg


def _jax(dtype, *xs):
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


def _torch(dtype, *xs):
    return [None if x is None else torch.tensor(x).to(dtype) for x in xs]


# b, lq, lk, h, hk, d, causal, window, segments
CASES = {
    "causal": (2, 128, 128, 2, 2, 32, True, 0, False),
    "noncausal": (2, 128, 128, 2, 2, 32, False, 0, False),
    "gqa": (1, 128, 128, 4, 2, 32, True, 0, False),
    "lq_lt_lk": (1, 64, 192, 2, 1, 32, True, 0, False),
    "lq_gt_lk": (1, 192, 64, 2, 2, 32, True, 0, False),
    "window": (1, 256, 256, 2, 2, 32, True, 48, False),
    "window_noncausal": (1, 128, 128, 2, 2, 32, False, 40, False),
    "segments": (2, 128, 128, 2, 2, 32, True, 0, True),
    "segments_gqa_window": (1, 128, 128, 4, 2, 32, True, 50, True),
}


# The block pairs the plain version runs at: the reference's 64 x 64 and
# each CUDA kernel's own tiles at every head dim, which the card holds the
# kernels against.
BLOCKS = sorted({(64, 64), *tflash.ALL_KERNEL_TILES})
# At 128-row or 128-key blocks a length must be a multiple of 128 (or
# shorter than the block): these cases keep their offsets at such lengths.
LONG = {"lq_lt_lk": (1, 128, 384, 2, 1, 32, True, 0, False),
        "lq_gt_lk": (1, 384, 128, 2, 2, 32, True, 0, False)}


def _case(name, block_q, block_k):
    if (block_q, block_k) != (64, 64) and name in LONG:
        return LONG[name]
    return CASES[name]


def _run_jax(q, k, v, g, seg, causal, window, block_q=64, block_k=64):
    q, k, v, g = _jax(jnp.float32, q, k, v, g)
    seg = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        return jflash.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                      block_k=block_k, segment_ids=seg,
                                      window=window)

    out, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(x) for x in (out, *vjp(g))]


def _run_torch(q, k, v, g, seg, causal, window, block_q=64, block_k=64):
    q, k, v, g = _torch(torch.float32, q, k, v, g)
    seg = None if seg is None else torch.tensor(seg)
    for x in (q, k, v):
        x.requires_grad_()
    out = tflash.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                 block_k=block_k, segment_ids=seg,
                                 window=window)
    out.backward(g)
    return [x.detach().float().numpy() for x in (out, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("name,block_q,block_k", [
    pytest.param(n, bq, bk, id=n if (bq, bk) == (64, 64) else f"{n}-{bq}x{bk}")
    for bq, bk in BLOCKS for n in sorted(CASES)])
def test_flash_matches_jax(name, block_q, block_k):
    b, lq, lk, h, hk, d, causal, window, segments = _case(name, block_q,
                                                          block_k)
    q, k, v, g, seg = _inputs(b, lq, lk, h, hk, d, segments=segments)
    want = _run_jax(q, k, v, g, seg, causal, window, block_q, block_k)
    got = _run_torch(q, k, v, g, seg, causal, window, block_q, block_k)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=2e-5)
    for a, w, n in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(a, w, atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{n} ({name})")


def test_flash_bf16_matches_jax():
    q, k, v, g, _ = _inputs(2, 128, 128, 4, 2, 32)
    want = jflash.flash_attention(*_jax(jnp.bfloat16, q, k, v), causal=True,
                                  block_q=64, block_k=64)
    got = tflash.flash_attention(*_torch(torch.bfloat16, q, k, v),
                                 causal=True, block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_flash_lse_matches_jax_forward_residual():
    q, k, v, _, _ = _inputs(1, 128, 128, 2, 2, 32)
    qt, kt, vt = (jnp.asarray(x).transpose(0, 2, 1, 3).reshape(2, 128, 32)
                  for x in (q, k, v))
    _, lse = jflash._flash_fwd(qt, kt, vt, 32 ** -0.5, True, 64, 64, True)
    _, got = tflash.flash_fwd_plain(*_torch(torch.float32, q, k, v),
                                    scale=32 ** -0.5, causal=True,
                                    block_q=64, block_k=64)
    np.testing.assert_allclose(got.reshape(2, 128).numpy(), np.asarray(lse),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["causal", "gqa", "lq_lt_lk", "window",
                                  "segments"])
def test_reference_attention_matches_jax(name):
    b, lq, lk, h, hk, d, causal, window, segments = CASES[name]
    q, k, v, _, seg = _inputs(b, lq, lk, h, hk, d, segments=segments)
    want = jattn.reference_attention(
        *_jax(jnp.float32, q, k, v), causal=causal, window=window,
        segment_ids=None if seg is None else jnp.asarray(seg))
    got = tattn.reference_attention(
        *_torch(torch.float32, q, k, v), causal=causal, window=window,
        segment_ids=None if seg is None else torch.tensor(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_block_rule_and_ragged_lengths():
    q, k, v = _torch(torch.float32, *_inputs(1, 100, 100, 2, 2, 16)[:3])
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k, v, block_q=64, block_k=64)
    # the default 512 blocks clamp to the 100-token sequence, as in JAX
    got = tflash.flash_attention(q, k, v)
    want = tattn.reference_attention(q, k, v)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_kv_segment_ids_without_segment_ids_raises():
    q, k, v = _torch(torch.float32, *_inputs(1, 64, 64, 2, 2, 16)[:3])
    with pytest.raises(ValueError, match="kv_segment_ids"):
        tflash.flash_attention(q, k, v,
                               kv_segment_ids=torch.zeros(1, 64, dtype=torch.int32))


def test_dispatch_on_cpu():
    q, k, v = _torch(torch.float32, *_inputs(1, 128, 128, 2, 2, 64)[:3])
    auto = tattn.attention(q, k, v, impl="auto")
    ref = tattn.reference_attention(q, k, v)
    assert torch.equal(auto, ref)          # auto takes no kernel on the CPU
    flash = tattn.attention(q, k, v, impl="flash")
    torch.testing.assert_close(flash, ref, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError):
        tattn.attention(q, k, v, impl="ring")


def test_flash_supported_rule():
    # the reference's rule, whatever the dtype; the kernel's own is narrower
    bf = torch.zeros(1, 256, 2, 64, dtype=torch.bfloat16)
    assert tattn._flash_supported(bf, bf)
    assert tattn._flash_supported(bf.float(), bf.float())
    assert not tattn._flash_supported(bf[:, :192], bf[:, :192])
    wide = torch.zeros(1, 256, 2, 256, dtype=torch.bfloat16)
    assert tattn._flash_supported(wide, wide)
    narrow = torch.zeros(1, 256, 2, 32, dtype=torch.bfloat16)
    assert not tattn._flash_supported(narrow, narrow)
    assert tattn._kernel_takes(bf)
    assert not tattn._kernel_takes(bf.float())
    assert not tattn._kernel_takes(wide)


def test_cpu_wrappers_never_launch_kernels():
    q, k, v, g, _ = _torch(torch.float32, *_inputs(1, 128, 128, 2, 2, 32))
    tflash.reset_launches()
    q.requires_grad_()
    tflash.flash_attention(q, k, v).backward(g)
    assert set(tflash.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("segments", [False, True])
def test_custom_ops_pass_opcheck(segments):
    """kftpu::flash_fwd (with its autograd) and kftpu::flash_bwd on CPU
    inputs: schema, fake tensors, autograd registration, AOT dispatch."""
    q, k, v, g, seg = _torch(torch.float32,
                             *_inputs(1, 128, 128, 4, 2, 32,
                                      segments=segments))
    seg = None if seg is None else seg.to(torch.int32)
    for x in (q, k, v):
        x.requires_grad_()
    args = (q, k, v, seg, seg, 32 ** -0.5, True, 64, 64, 0)
    torch.library.opcheck(torch.ops.kftpu.flash_fwd.default, args)
    out, lse = torch.ops.kftpu.flash_fwd(*args)
    assert not lse.requires_grad            # lse takes no gradient
    torch.library.opcheck(torch.ops.kftpu.flash_bwd.default, (
        q.detach(), k.detach(), v.detach(), out.detach(), lse, g, seg, seg,
        32 ** -0.5, True, 64, 64, 0))
