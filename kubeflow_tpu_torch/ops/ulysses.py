"""Ulysses sequence parallelism: all-to-all head sharding for attention
(port of kubeflow_tpu/ops/ulysses.py).

An all-to-all over the `seq` group turns seq-sharded [B, L/sp, H, D]
into head-sharded [B, L, H/sp, D]: rank r gathers every rank's block of
its head group r. Each rank then runs ordinary attention over the whole
sequence through `ops/attention.py`'s dispatch (on a CUDA device, the
flash kernels), and a second all-to-all restores the sequence sharding.
Both exchanges are differentiable (the backward is the inverse
exchange). Segment ids are all-gathered; GQA k/v are repeated to the q
heads before the exchange. Without a `seq` group the call is the local
`attention()`, as the reference's fallback.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops.attention import _repeat_kv, attention


class _AllToAll(torch.autograd.Function):
    """Chunk i of dim 0 goes to rank i of `group`, and chunk i of the
    result came from rank i. With equal chunks the exchange is its own
    inverse, so the backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable all-to-all over dim 0 (equal chunks, one per
    rank of `group`)."""
    return _AllToAll.apply(x, group)


def _seq_to_heads(x: torch.Tensor, sp: int, group) -> torch.Tensor:
    """[b, l, h, d] (this rank's positions) -> [b, sp*l, h/sp, d] (every
    position, this rank's heads)."""
    b, l, h, d = x.shape
    x = x.reshape(b, l, sp, h // sp, d).permute(2, 0, 1, 3, 4)
    x = all_to_all(x, group)                # [src rank, b, l, h/sp, d]
    return x.permute(1, 0, 2, 3, 4).reshape(b, sp * l, h // sp, d)


def _heads_to_seq(x: torch.Tensor, sp: int, group) -> torch.Tensor:
    """The inverse of _seq_to_heads."""
    b, length, hs, d = x.shape
    l = length // sp
    x = x.reshape(b, sp, l, hs, d).permute(1, 0, 2, 3, 4)
    x = all_to_all(x, group)                # [head group, b, l, h/sp, d]
    return x.permute(1, 2, 0, 3, 4).reshape(b, l, sp * hs, d)


def ulysses_attention(q, k, v, *, seq=None, causal: bool = True,
                      impl: str = "auto",
                      segment_ids: torch.Tensor | None = None,
                      block_q: int = 0, block_k: int = 0, window: int = 0,
                      model_size: int = 1) -> torch.Tensor:
    """Attention over seq-sharded [B, L/sp, H, D] blocks through the head
    all-to-all; `seq` is the mesh.AxisGroup of the `seq` axis, H this
    rank's heads (of H * model_size under tensor parallelism).
    `segment_ids` [B, L/sp] are this rank's ids."""
    if seq is None or seq.size == 1:
        return attention(q, k, v, causal=causal, impl=impl,
                         segment_ids=segment_ids, block_q=block_q,
                         block_k=block_k, window=window)
    sp = seq.size
    h = q.shape[2]
    if h % sp:
        raise ValueError(
            f"ulysses needs heads-per-device {h} divisible by seq-axis size "
            f"{sp} (H={h * model_size}, model={model_size})")
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    qg, kg, vg = (_seq_to_heads(t, sp, seq.group) for t in (q, k, v))
    seg = None
    if segment_ids is not None:
        import torch.distributed as dist

        parts = [torch.empty_like(segment_ids) for _ in range(sp)]
        dist.all_gather(parts, segment_ids.contiguous(), group=seq.group)
        seg = torch.cat(parts, 1)
    out = attention(qg, kg, vg, causal=causal, impl=impl, segment_ids=seg,
                    block_q=block_q, block_k=block_k, window=window)
    return _heads_to_seq(out, sp, seq.group)
