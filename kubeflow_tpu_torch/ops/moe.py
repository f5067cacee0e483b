"""Mixture-of-experts with expert parallelism (port of
kubeflow_tpu/ops/moe.py).

Two dispatch paths behind one module, the reference's:

- **dense** (Switch/GShard one-hot einsums, the oracle): per batch row,
  routed (token, slot) pairs take their arrival position within their
  expert (an exclusive cumsum over the row) and keep it when it is below
  the row's capacity `int(cf * s * k / e) or 1`; dispatch and combine
  are einsums against the [b, s, e, c] one-hot tensors.
- **sparse** (`sparse_dispatch_mlp`): per token shard (this rank's
  rows), the pairs are sorted by expert id (a stable sort, as
  `jnp.argsort`), written into per-expert capacity buffers of
  `max(1, int(cf * t * k / e))` rows (overflow lands on an extra row
  that is dropped, the reference's `mode="drop"`), exchanged over the
  `expert` axis with an all-to-all, run through the local experts as one
  batched GEMM, returned by the inverse all-to-all and combined with an
  f32 `index_add_` weighted by the gates.

Which path runs is the reference's choice, made there from the ambient
mesh (`_sparse_ok`): sparse when a mesh is ambient and its fsdp, model,
seq and pipe axes are all 1 (and the experts divide over `expert`),
dense otherwise. The port has no ambient mesh, so the caller states it:
`MoEBlock.sparse` is False (no mesh: `generate`, the servers) unless the
trainer sets it from its mesh (`parallel/shardings.py apply_moe`).

The three diagnostics (`moe_fill`, `moe_drop`, `moe_sparse_dispatch`)
and the Switch/T5X load-balancing loss, taken from the router's
pre-capacity top-k assignment, are left in `MoEBlock.stats` after each
forward; the trainer sums the counts over the token shards. The
forward's router, dispatch, expert GEMMs and combine run under
`torch.profiler.record_function` ranges (`moe.router`, `moe.dispatch`,
`moe.experts`, `moe.combine`), which a profile reads by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from kubeflow_tpu_torch.ops.ulysses import all_to_all


def _identity(x):
    return x


def router(x: torch.Tensor, weight: torch.Tensor, k: int):
    """Top-k routing, f32: (probs [..., e], gates [..., k] renormalised
    to sum 1, expert ids [..., k])."""
    probs = torch.softmax(F.linear(x.float(), weight.float()), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, idx


def expert_mlp(xin, w_gate, w_up, w_down, dtype):
    """Batched SwiGLU over experts: xin [e, t, d] -> [e, t, d]."""
    h = F.silu(torch.bmm(xin, w_gate.to(dtype))) * torch.bmm(
        xin, w_up.to(dtype))
    return torch.bmm(h, w_down.to(dtype))


def sparse_dispatch_mlp(x, gates, idx, w_gate, w_up, w_down,
                        capacity_factor: float, dtype, expert=None):
    """Sort-based dispatch, expert MLP and combine over this rank's tokens:
    x [t, d], gates/idx [t, k], expert weights [e_local, ...]; `expert`
    (a mesh.AxisGroup) exchanges the capacity buffers over the expert
    axis, so e = e_local * expert.size. Returns (y [t, d], kept, routed,
    slots): this shard's kept pairs, routed pairs and capacity slots."""
    t, d = x.shape
    k = idx.shape[-1]
    ep = expert.size if expert is not None else 1
    e_local = w_gate.shape[0]
    e = e_local * ep
    cap = max(1, int(capacity_factor * t * k / e))
    with record_function("moe.dispatch"):
        eidx = idx.reshape(-1)
        order = torch.argsort(eidx, stable=True)
        sorted_e = eidx[order]
        sorted_tok = order // k
        counts = torch.bincount(eidx, minlength=e)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(t * k, device=x.device) - starts[sorted_e]
        keep = pos < cap
        # overflow goes to row e*cap, cut off after the scatter
        slot = torch.where(keep, sorted_e * cap + pos, e * cap)
        buf = torch.zeros(e * cap + 1, d, dtype=dtype, device=x.device)
        buf = buf.index_copy(0, slot, x[sorted_tok].to(dtype))[:e * cap]
        if ep > 1:
            # every rank's buffers for this rank's experts
            buf = all_to_all(buf.reshape(ep, e_local * cap, d), expert.group)
            xin = buf.reshape(ep, e_local, cap, d).transpose(0, 1).reshape(
                e_local, ep * cap, d)
        else:
            xin = buf.reshape(e_local, cap, d)
    with record_function("moe.experts"):
        out = expert_mlp(xin, w_gate, w_up, w_down, dtype)
    with record_function("moe.combine"):
        if ep > 1:
            out = out.reshape(e_local, ep, cap, d).transpose(0, 1).reshape(
                ep, e_local * cap, d)
            out = all_to_all(out, expert.group)
        flat = torch.cat([out.reshape(e * cap, d),
                          out.new_zeros(1, d)])          # the fill row
        contrib = flat[slot]
        w = torch.where(keep, gates.reshape(-1)[order].float(),
                        torch.zeros((), device=x.device))
        y = torch.zeros(t, d, dtype=torch.float32, device=x.device).index_add(
            0, sorted_tok, contrib.float() * w[:, None])
    return y.to(dtype), keep.sum(), t * k, e * cap


def dense_dispatch_mlp(x, gates, idx, w_gate, w_up, w_down,
                       capacity_factor: float, dtype, seq=None,
                       tp_in=_identity, tp_out=_identity):
    """The one-hot dispatch over x [b, s, d] (the oracle): capacity per
    batch row. With `seq` (a mesh.AxisGroup: this rank holds positions
    [rank*s, (rank+1)*s) of every row) the capacity is that of the whole
    row and arrival positions continue from the ranks before this one.
    Returns (y, kept, routed, slots), this rank's counts."""
    b, s, d = x.shape
    e, k = w_gate.shape[0], idx.shape[-1]
    sp, srank = (seq.size, seq.rank) if seq is not None else (1, 0)
    capacity = int(capacity_factor * s * sp * k / e) or 1
    with record_function("moe.dispatch"):
        assign = F.one_hot(idx, e).float()                # [b, s, k, e]
        flat = assign.reshape(b, s * k, e)
        pos = torch.cumsum(flat, 1) - flat                # arrival order
        if sp > 1:
            import torch.distributed as dist

            counts = [torch.empty(b, e, device=x.device) for _ in range(sp)]
            dist.all_gather(counts, flat.sum(1).contiguous(), group=seq.group)
            pos = pos + sum(counts[:srank], torch.zeros(
                b, e, device=x.device))[:, None]
        pos = pos.reshape(b, s, k, e)
        assign = assign * (pos < capacity)                # drop overflow
        pos_oh = F.one_hot(pos.long().clamp_max(capacity - 1),
                           capacity).float()
        dispatch = torch.einsum("bske,bskec->bsec", assign, pos_oh)
        combine = torch.einsum("bsk,bske,bskec->bsec", gates.float(), assign,
                               pos_oh)
        xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(dtype), x.to(dtype))
    with record_function("moe.experts"):
        xin = tp_in(xin.reshape(e, b * capacity, d))
        out = tp_out(expert_mlp(xin, w_gate, w_up, w_down, dtype))
    with record_function("moe.combine"):
        y = torch.einsum("bsec,ebcd->bsd", combine.to(dtype),
                         out.reshape(e, b, capacity, d))
    slots = b * e * capacity if srank == 0 else 0       # once per row
    return y, assign.sum(), b * s * k, slots


class _GatherExperts(torch.autograd.Function):
    """All-gather the expert dim over the expert group; the backward sums
    the gradient over the group (each rank's tokens reach every expert)
    and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, w, group, n, rank):
        import torch.distributed as dist

        ctx.group, ctx.n, ctx.rank = group, n, rank
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w.contiguous(), group=group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n, 0)[ctx.rank].contiguous(), None, None, None


class MoEBlock(nn.Module):
    """Drop-in replacement for the SwiGLU MLP: an f32 router [e, d] and the
    expert weights w_gate, w_up [e, d, f] and w_down [e, f, d] (f32, the
    reference's layout and names under `layer_i/moe/`).

    Placement, set by the trainer from its mesh (defaults: one process,
    dense): `sparse` picks the sparse path; `expert` (an AxisGroup) holds
    this rank's slice of the experts (dim 0 split over `expert`);
    `tokens` is the group over which the reference's global batch is
    spread (batch axes and seq), for the load-balancing loss; `seq` the
    sequence group (dense arrival positions); `tp_in`/`tp_out` the
    tensor-parallel collectives around the expert MLP, as SwiGLU's."""

    def __init__(self, cfg, device):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.capacity_factor = cfg.moe_capacity_factor
        self.router = nn.Module()
        self.router.weight = nn.Parameter(torch.empty(e, d, device=device))
        self.w_gate = nn.Parameter(torch.empty(e, d, f, device=device))
        self.w_up = nn.Parameter(torch.empty(e, d, f, device=device))
        self.w_down = nn.Parameter(torch.empty(e, f, d, device=device))
        self.sparse = False
        self.expert = self.tokens = self.seq = None
        self.tp_in = self.tp_out = _identity
        self.stats: dict | None = None

    def _weights(self):
        w = (self.w_gate, self.w_up, self.w_down)
        if self.expert is None or self.sparse:
            return w
        ex = self.expert
        return tuple(_GatherExperts.apply(t, ex.group, ex.size, ex.rank)
                     for t in w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = x.shape
        k, dt = cfg.expert_top_k, cfg.dtype
        with record_function("moe.router"):
            probs, gates, idx = router(x, self.router.weight, k)
        wg, wu, wd = self._weights()
        if self.sparse:
            y, kept, routed, slots = sparse_dispatch_mlp(
                x.reshape(b * s, d), gates.reshape(b * s, k),
                idx.reshape(b * s, k), wg, wu, wd, self.capacity_factor, dt,
                self.expert)
            y = y.reshape(b, s, d)
        else:
            y, kept, routed, slots = dense_dispatch_mlp(
                x, gates, idx, wg, wu, wd, self.capacity_factor, dt,
                self.seq, self.tp_in, self.tp_out)
        self.stats = {"aux": self._aux(probs, idx),
                      "counts": torch.stack([
                          torch.as_tensor(kept, dtype=torch.float32,
                                          device=x.device),
                          torch.tensor(float(routed), device=x.device),
                          torch.tensor(float(slots), device=x.device)]),
                      "sparse": float(self.sparse)}
        return y.to(dt)

    def _aux(self, probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """This rank's part of e * sum(me * ce) over the global batch: me
        the mean router probability, ce the mean pre-capacity assignment
        count per expert, both over every token of the `tokens` group;
        the parts sum over the group to the reference's loss (ce is a
        constant of the gradient, as there)."""
        e = self.cfg.n_experts
        n = probs.shape[0] * probs.shape[1]
        ce = F.one_hot(idx, e).float().sum(2).sum((0, 1))
        if self.tokens is not None:
            import torch.distributed as dist

            dist.all_reduce(ce, group=self.tokens.group)
            n *= self.tokens.size
        me = probs.sum((0, 1)) / n
        return e * torch.sum(me * (ce / n))
