"""Attention entry point: one call site, the implementation chosen per
device. Port of kubeflow_tpu/ops/attention.py.

`attention()` routes to the hand-written CUDA flash kernels on a CUDA
device for every input the reference sends to its flash kernel, and to
the plain `reference_attention` elsewhere. Shapes are [batch, length, heads,
head_dim]; grouped-query attention passes fewer kv heads than q heads.
"""

from __future__ import annotations

import os

import torch

NEG_FILL = -1e30   # not -inf: a fully masked row averages, never NaN
ENV_BLOCK_Q, ENV_BLOCK_K = "KFTPU_FLASH_BLOCK_Q", "KFTPU_FLASH_BLOCK_K"


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
                        window: int = 0,
                        kv_segment_ids: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Attention with f32 logits and softmax. BLHD in, BLHD out. Causality
    is end-aligned (tril(k=lk-lq)); window > 0 lets query i attend keys
    in (i - window, i]. kv_segment_ids [B, Lk] default to segment_ids."""
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
        kseg = segment_ids if kv_segment_ids is None else kv_segment_ids
        seg = segment_ids[:, :, None] == kseg[:, None, :]
        logits = torch.where(seg[:, None], logits, NEG_FILL)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(v.dtype)


def attention(q, k, v, *, causal: bool = True, impl: str = "auto",
              segment_ids: torch.Tensor | None = None, block_q: int = 0,
              block_k: int = 0, window: int = 0) -> torch.Tensor:
    """Dispatching attention. impl: auto | flash | reference. `auto` takes
    the flash kernels on a CUDA device for every input the reference
    sends to its kernel (`_flash_supported`; `KERNEL_DOMAIN` covers all
    of it), the plain reference path elsewhere. block_q / block_k set the
    plain version's blocks (`flash_blocks`); the CUDA kernels tile at
    their own sizes."""
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal,
                                   segment_ids=segment_ids, window=window)
    if impl not in ("auto", "flash"):
        raise ValueError(f"unknown attention impl {impl!r} "
                         "(auto|flash|reference)")
    if impl == "flash" or (q.device.type == "cuda"
                           and _flash_supported(q, k)):
        from kubeflow_tpu_torch.ops.flash_attention import flash_attention

        bq, bk, origin = flash_blocks(block_q, block_k)
        return flash_attention(q, k, v, causal=causal, block_q=bq,
                               block_k=bk, segment_ids=segment_ids,
                               window=window, blocks_from=origin)
    return reference_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids, window=window)


def flash_blocks(block_q: int = 0, block_k: int = 0) -> tuple[int, int, str]:
    """The flash call's block sizes, in the reference's order: the
    call's, else $KFTPU_FLASH_BLOCK_Q / $KFTPU_FLASH_BLOCK_K (read at
    each call, as the reference reads them at trace time: autotuning
    sweeps set them per subprocess), else the default. Returns them and
    where they came from, for the kernels' warning about sizes they do
    not tile at."""
    from kubeflow_tpu_torch.ops.flash_attention import (
        DEFAULT_BLOCK_K,
        DEFAULT_BLOCK_Q,
    )

    bq, q_from = _block(block_q, ENV_BLOCK_Q, DEFAULT_BLOCK_Q)
    bk, k_from = _block(block_k, ENV_BLOCK_K, DEFAULT_BLOCK_K)
    return bq, bk, f"block_q {q_from}, block_k {k_from}"


def _block(arg: int, var: str, default: int) -> tuple[int, str]:
    if arg:
        return arg, "from the call"
    if var in os.environ:
        return int(os.environ[var]), f"from ${var}"
    return default, "by default"


def _flash_supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The reference's rule for taking its flash kernel: lengths % 128,
    head_dim 64, 128 or 256, any dtype."""
    return flash_rule(q.shape[1], k.shape[1], q.shape[-1])


def flash_rule(lq: int, lk: int, head_dim: int) -> bool:
    """_flash_supported on the lengths and head dim alone."""
    return lq % 128 == 0 and lk % 128 == 0 and head_dim in (64, 128, 256)

