"""Local attention on a seq mesh axis: each rank's q block attends the
K/V of the whole sequence, gathered over the `seq` group.

The reference lets GSPMD gather K/V when `attention_impl` is auto,
flash or reference on a `seq` mesh (kubeflow_tpu/models/transformer.py,
`Attention.__call__`); the port holds this rank's block of positions
and gathers explicitly:

- K, V and the key segment ids are all-gathered over the group. The
  gather is an autograd Function whose backward sums each rank's dK/dV
  over the group (an all-reduce, which gloo also takes on CUDA tensors)
  and keeps this rank's block.
- Causal attention passes rank r of n (positions [r b, (r + 1) b)) only
  the key prefix [0, (r + 1) b): the kernels' and the plain path's
  end-aligned causal offset (Lk - Lq = r b) is then exactly the causal
  offset, and the window rule, relative to it, stays right. Non-causal
  attention (BERT) attends the whole gathered K/V under its padding
  mask; with a window it must also see q at its true positions (the
  window rule places q end-aligned over the keys it is given, (n-1) b
  for any block of n b keys), so q is gathered as well and this rank's
  rows are kept.
- `auto` decides flash or reference on the full length, as the
  reference does (`attention.flash_rule`): flash on a CUDA tensor
  for the lengths % 128 the reference sends to its kernel, the plain
  reference path on the CPU and elsewhere. Where the rank's block breaks
  the kernels' 128-length rule but the full length keeps it, q is
  gathered as well and this rank's rows are kept, as GSPMD lays it out.

Without a seq group (or at extent 1) the call is the local
`attention()`.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops.attention import (
    attention,
    flash_blocks,
    flash_rule,
    reference_attention,
)

IMPLS = ("auto", "flash", "reference")


def _all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 1)


class _Gather(torch.autograd.Function):
    """Every rank's block of dim 1, in rank order; the backward sums the
    gradient over the group and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank, ctx.block = group, rank, x.shape[1]
        return _all_gather(x, group, size)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        lo = ctx.rank * ctx.block
        return g[:, lo:lo + ctx.block].contiguous(), None, None, None


def gather_seq(x: torch.Tensor, seq) -> torch.Tensor:
    """x [B, L/n, ...] of every rank of `seq` (a mesh.AxisGroup) as
    [B, L, ...], differentiable."""
    return _Gather.apply(x, seq.group, seq.rank, seq.size)


def seq_attention(q, k, v, *, seq=None, causal: bool = True,
                  impl: str = "auto",
                  segment_ids: torch.Tensor | None = None,
                  block_q: int = 0, block_k: int = 0,
                  window: int = 0) -> torch.Tensor:
    """This rank's q block [B, L/n, H, D] attending the sequence's K/V,
    gathered over `seq`; k/v [B, L/n, Hkv, D] and `segment_ids`
    [B, L/n] are this rank's blocks. impl: auto | flash | reference."""
    if seq is None or seq.size == 1:
        return attention(q, k, v, causal=causal, impl=impl,
                         segment_ids=segment_ids, block_q=block_q,
                         block_k=block_k, window=window)
    if impl not in IMPLS:
        raise ValueError(f"seq_attention takes impl {'|'.join(IMPLS)}, "
                         f"not {impl!r}")
    from kubeflow_tpu_torch.ops import flash_attention as fa

    n, r, b = seq.size, seq.rank, q.shape[1]
    k_all, v_all = gather_seq(k, seq), gather_seq(v, seq)
    seg_all = None
    if segment_ids is not None:
        seg_all = _all_gather(segment_ids, seq.group, n)
    keep = (r + 1) * b if causal else n * b
    k_use, v_use = k_all[:, :keep], v_all[:, :keep]
    kseg = None if seg_all is None else seg_all[:, :keep]
    on_card = q.device.type == "cuda"
    # the reference's dispatch, on the full length
    flash = impl == "flash" or (impl == "auto" and on_card and flash_rule(
        n * b, n * b, q.shape[-1]))
    # the window needs q's true positions, or this rank's block breaks
    # the kernels' length rule: attend with every rank's rows and keep
    # this rank's
    whole = (not causal and window > 0) or (
        flash and on_card and b % fa.KERNEL_LENGTH != 0)
    if whole:
        q_use, k_use, v_use, qseg, kseg = (gather_seq(q, seq), k_all, v_all,
                                           seg_all, None)
    else:
        q_use, qseg = q, segment_ids
    if not flash:
        out = reference_attention(q_use, k_use, v_use, causal=causal,
                                  segment_ids=qseg, kv_segment_ids=kseg,
                                  window=window)
    else:
        bq, bk, origin = flash_blocks(block_q, block_k)
        out = fa.flash_attention(q_use, k_use, v_use, causal=causal,
                                 segment_ids=qseg, kv_segment_ids=kseg,
                                 window=window, block_q=bq, block_k=bk,
                                 blocks_from=origin)
    return out[:, r * b:(r + 1) * b] if whole else out
