"""Attention entry point: one call site, the implementation chosen per
device. Port of kubeflow_tpu/ops/attention.py.

`attention()` routes to the hand-written CUDA flash kernel on a CUDA
device for the shapes the reference sends to its flash kernel, and to
the plain `reference_attention` elsewhere. Shapes are [batch, length, heads,
head_dim]; grouped-query attention passes fewer kv heads than q heads.
"""

from __future__ import annotations

import torch

NEG_FILL = -1e30   # not -inf: a fully masked row averages, never NaN


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Broadcast kv heads up to q heads for grouped-query attention."""
    num_kv = k.shape[2]
    if num_kv == num_q_heads:
        return k
    if num_q_heads % num_kv:
        raise ValueError(f"{num_q_heads} q heads not a multiple of {num_kv}")
    return k.repeat_interleave(num_q_heads // num_kv, dim=2)


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None,
                        segment_ids: torch.Tensor | None = None,
                        window: int = 0) -> torch.Tensor:
    """Attention with f32 logits and softmax. BLHD in, BLHD out. Causality
    is end-aligned (tril(k=lk-lq)); window > 0 lets query i attend keys
    in (i - window, i]."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((lq, lk), dtype=torch.bool,
                          device=q.device).tril(lk - lq)
        logits = torch.where(mask, logits, NEG_FILL)
    if window > 0:
        qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        kpos = torch.arange(lk, device=q.device)[None, :]
        logits = torch.where(qpos - kpos < window, logits, NEG_FILL)
    if segment_ids is not None:
        seg = segment_ids[:, :, None] == segment_ids[:, None, :]
        logits = torch.where(seg[:, None], logits, NEG_FILL)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(v.dtype)


def attention(q, k, v, *, causal: bool = True, impl: str = "auto",
              segment_ids: torch.Tensor | None = None, block_q: int = 0,
              block_k: int = 0, window: int = 0) -> torch.Tensor:
    """Dispatching attention. impl: auto | flash | reference. `auto` takes
    the flash kernel on a CUDA device for the shapes the reference sends
    to its kernel (`_flash_supported`); of those, the ones the CUDA
    kernel lacks raise rather than take the [B, H, L, L] reference path.
    block_q / block_k set the plain version's blocks; the CUDA kernel
    tiles at its own size."""
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal,
                                   segment_ids=segment_ids, window=window)
    if impl not in ("auto", "flash"):
        raise ValueError(f"unknown attention impl {impl!r} "
                         "(auto|flash|reference)")
    on_card = q.device.type == "cuda"
    if impl == "auto" and on_card and _flash_supported(q, k) \
            and not _kernel_takes(q):
        raise NotImplementedError(
            f"attention_impl auto: the reference sends {q.dtype} with "
            f"head_dim {q.shape[-1]} to its flash kernel, but the CUDA "
            "kernel takes bf16 with head_dim 64 or 128 (ROADMAP Queue 2, "
            "item 5); pass attention_impl 'reference' to run the plain "
            "path")
    if impl == "flash" or (on_card and _flash_supported(q, k)):
        from kubeflow_tpu_torch.ops.flash_attention import (
            DEFAULT_BLOCK_K,
            DEFAULT_BLOCK_Q,
            flash_attention,
        )

        return flash_attention(q, k, v, causal=causal,
                               block_q=block_q or DEFAULT_BLOCK_Q,
                               block_k=block_k or DEFAULT_BLOCK_K,
                               segment_ids=segment_ids, window=window)
    return reference_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids, window=window)


def _flash_supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The reference's rule for taking its flash kernel: lengths % 128,
    head_dim 64, 128 or 256, any dtype."""
    return (q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0
            and q.shape[-1] in (64, 128, 256))


def _kernel_takes(q: torch.Tensor) -> bool:
    """What the CUDA kernel takes beyond that: bf16, head_dim 64 or 128."""
    from kubeflow_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    return q.dtype == torch.bfloat16 and q.shape[-1] in KERNEL_HEAD_DIMS
