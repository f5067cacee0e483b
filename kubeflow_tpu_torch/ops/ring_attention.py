"""Ring attention: exact attention over sequence-sharded inputs (port of
kubeflow_tpu/ops/ring_attention.py).

Each rank of the `seq` group holds one block of L/sp positions of Q, K
and V. K/V blocks travel around the ring (rank r sends to r+1 and
receives from r-1, `batch_isend_irecv`), and each rank keeps a
streaming-softmax accumulator (running max, sum and output) over the
blocks it sees, so the result is exactly softmax(QK^T)V. Every hop is
the reference's `_block_attn`: f32 einsums with the causal, window and
segment masks on global positions; the flash kernels are not used. The
K-side segment ids travel with their K/V block. Under a causal window
the ring stops after the hops that can reach the window (`n_hops`), and
the last block is never sent on.

The shift is an autograd Function whose backward shifts the gradient
the other way, so the backward runs the ring in reverse. Without a
`seq` group the call falls back to `reference_attention`, as the
reference falls back when its mesh has no `seq` axis.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops.attention import _repeat_kv, reference_attention

NEG_INF = -1e30


def _block_attn(q, k, v, row_ids, col_ids, scale, causal, qseg=None,
                kseg=None, window: int = 0):
    """One block pair: (unnormalised out [b, q, h, d], row max [b, h, q],
    row sum [b, h, q]), all f32."""
    h = q.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None                                       # [b|1, q, k]
    if causal:
        mask = (row_ids[:, None] >= col_ids[None, :])[None]
    if window > 0:
        near = ((row_ids[:, None] - col_ids[None, :]) < window)[None]
        mask = near if mask is None else mask & near
    if qseg is not None:
        seg = qseg[:, :, None] == kseg[:, None, :]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        logits = torch.where(mask[:, None], logits, NEG_INF)
    # a fully masked row: exp(NEG_INF - NEG_INF) would be 1
    m = logits.amax(-1).clamp_min(-1e29)
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        p = torch.where(mask[:, None], p, 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m, p.sum(-1)


def _exchange(xs, send_to: int, recv_from: int, group):
    """Send each of `xs` to global rank `send_to` and receive tensors
    like them from `recv_from`, in one batch."""
    import torch.distributed as dist

    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    ops = [dist.P2POp(dist.isend, x, send_to, group) for x in xs]
    ops += [dist.P2POp(dist.irecv, o, recv_from, group) for o in outs]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return outs


class _Shift(torch.autograd.Function):
    """(k, v) from the previous rank of the ring; the backward sends the
    gradients back to it."""

    @staticmethod
    def forward(ctx, k, v, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return tuple(_exchange((k, v), nxt, prv, group))

    @staticmethod
    def backward(ctx, gk, gv):
        dk, dv = _exchange((gk, gv), ctx.prv, ctx.nxt, ctx.group)
        return dk, dv, None, None, None


def ring_attention(q, k, v, *, seq=None, causal: bool = True,
                   segment_ids: torch.Tensor | None = None,
                   window: int = 0) -> torch.Tensor:
    """Exact attention over seq-sharded [B, L/sp, H, D] blocks; `seq` is
    the mesh.AxisGroup of the `seq` axis (this rank's block is number
    seq.rank). `causal=False` is the bidirectional (BERT) ring.
    `segment_ids` [B, L/sp] are this rank's ids. Without `seq`, the
    plain reference_attention over the whole inputs."""
    if seq is None or seq.size == 1:
        return reference_attention(q, k, v, causal=causal,
                                   segment_ids=segment_ids, window=window)
    n, r = seq.size, seq.rank
    ranks = seq.ranks
    nxt, prv = ranks[(r + 1) % n], ranks[(r - 1) % n]
    h = q.shape[2]
    # GQA: repeat the kv heads before the ring, as the reference does
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    b, lb, _, d = q.shape
    scale = d ** -0.5
    ar = torch.arange(lb, device=q.device)
    row_ids = r * lb + ar
    o = torch.zeros(b, lb, h, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lb), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, lb, dtype=torch.float32, device=q.device)
    # causal + window: hop i's nearest pair is (i-1)*lb+1 apart, so hops
    # past ceil((window-1)/lb) see nothing inside the window
    n_hops = n
    if causal and window > 0:
        n_hops = min(n, max(1, (window - 2) // lb + 2))
    kseg = segment_ids
    for i in range(n_hops):
        col_ids = ((r - i) % n) * lb + ar
        o_i, m_i, l_i = _block_attn(q, k, v, row_ids, col_ids, scale, causal,
                                    segment_ids, kseg, window)
        m_new = torch.maximum(m, m_i)
        alpha, beta = torch.exp(m - m_new), torch.exp(m_i - m_new)
        l = l * alpha + l_i * beta
        o = (o * alpha.transpose(1, 2)[..., None]
             + o_i * beta.transpose(1, 2)[..., None])
        m = m_new
        if i < n_hops - 1:          # the last block is not sent on
            k, v = _Shift.apply(k, v, seq.group, nxt, prv)
            if kseg is not None:
                (kseg,) = _exchange((kseg,), nxt, prv, seq.group)
    out = o / l.clamp_min(1e-20).transpose(1, 2)[..., None]
    return out.to(q.dtype)
