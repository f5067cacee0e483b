"""Adafactor: a hand port of `optax.adafactor` as the reference builds it
(kubeflow_tpu/runtime/trainer.py make_optimizer: the learning-rate
schedule, multiply_by_parameter_scale=True, weight_decay_rate =
weight_decay or None, optax's defaults for the rest).

One update, per parameter, in f32 (optax/_src/alias.py, the `tx` chain):
1. scale_by_factored_rms: eps is added to g^2; the second moment decays
   at 1 - (t + 1)^-0.8, t counting updates from 0 (so the first update
   has decay 0). A parameter whose two largest dims are both >= 128 keeps
   a row and a column statistic (the row one normalized by its mean);
   any other keeps a full one. u = g / sqrt(second moment).
2. clip_by_block_rms(1.0): u / max(1, rms(u)).
3. times the learning rate;
4. times max(rms(param), 1e-3) (scale_by_param_block_rms);
5. plus weight_decay * param, after the learning rate: not scaled by it;
6. times -1, added to the parameter.

Factoring follows the shape each parameter has in the reference's flax
tree, not the port's: the q/k/v kernels are [d, H, D] there and o is
[H, D, d], so at head_dim 64 they keep a full second moment, where the
port's [out, in] = [2048, 2048] weight would be factored. Each parameter
is therefore viewed in its flax layout (`convert.flax_layout`) and the
state lives in that shape. `torch.optim.Adafactor` has other semantics
(beta2_decay, an eps pair, no parameter scale) and is not used.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

Layout = tuple[tuple[int, ...], tuple[int, ...]]   # (view, perm)

# optax.adafactor's defaults, which the reference keeps
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
CLIPPING_THRESHOLD = 1.0
EPS = 1e-30
MIN_PARAM_SCALE = 1e-3      # scale_by_param_block_rms's floor


def factored_dims(shape: Sequence[int]) -> tuple[int, int] | None:
    """optax's _factored_dims: (second-largest dim, largest dim), or None
    when the second-largest is below MIN_DIM_SIZE_TO_FACTOR."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x.square().mean().sqrt()


class Adafactor(torch.optim.Optimizer):
    """optax.adafactor with its defaults (no momentum). `layouts`,
    one per parameter (or None for all as they are), gives the (view,
    perm) that shows each parameter in its reference shape. The learning
    rate is the group's `lr`, set by the caller before each step."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 0.0, *,
                 layouts: Sequence[Layout | None] | None = None,
                 weight_decay: float | None = None):
        params = list(params)
        layouts = [None] * len(params) if layouts is None else list(layouts)
        if len(layouts) != len(params):
            raise ValueError(f"{len(layouts)} layouts for {len(params)} "
                             "parameters")
        super().__init__(params, dict(lr=lr))
        self.layouts = {p: lay for p, lay in zip(params, layouts)
                        if lay is not None}
        self.weight_decay = weight_decay

    def _ref(self, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """x (p or its gradient) as a view in p's reference layout."""
        lay = self.layouts.get(p)
        return x if lay is None else x.view(lay[0]).permute(lay[1])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adafactor.step takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, group["lr"])

    def _update(self, p: torch.Tensor, lr: float) -> None:
        g, w = self._ref(p, p.grad), self._ref(p, p)
        state = self.state[p]
        dims = factored_dims(g.shape)
        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros(g.shape, dtype=p.dtype,
                                         device=p.device)
            else:
                d1, d0 = dims
                state["v_row"] = torch.zeros(
                    [n for i, n in enumerate(g.shape) if i != d0],
                    dtype=p.dtype, device=p.device)
                state["v_col"] = torch.zeros(
                    [n for i, n in enumerate(g.shape) if i != d1],
                    dtype=p.dtype, device=p.device)
        # decay_rate_t in f32, as optax's _decay_rate_pow computes it
        t = np.float32(state["step"] + 1)
        decay = np.float32(1.0) - t ** np.float32(-DECAY_RATE)
        keep, take = float(decay), float(np.float32(1.0) - decay)
        g2 = g.square() + EPS
        if dims is None:
            v = state["v"]
            v.mul_(keep).add_(g2 * take)
            u = g * v.pow(-0.5)
        else:
            d1, d0 = dims
            v_row, v_col = state["v_row"], state["v_col"]
            v_row.mul_(keep).add_(g2.mean(d0) * take)
            v_col.mul_(keep).add_(g2.mean(d1) * take)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)
                          ).pow(-0.5)
            u = g * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
        u = u / (_rms(u) / CLIPPING_THRESHOLD).clamp_min(1.0)
        u = u * lr
        u = u * _rms(w).clamp_min(MIN_PARAM_SCALE)
        if self.weight_decay is not None:
            u = u + self.weight_decay * w
        w.sub_(u)
        state["step"] += 1
