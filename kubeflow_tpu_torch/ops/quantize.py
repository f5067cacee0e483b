"""Symmetric int8/int4 quantization (port of kubeflow_tpu/ops/quantize.py).

One copy of the scale/round/clip recipe for both users: weight-only
serving quantization (serving/quant.py, per output channel) and the
int8 decode KV cache (models/transformer.py, per position and head).
`torch.round` rounds half to even, as `jnp.round` does, and the scale
and quotient are single f32 divisions on both sides, so codes and
scales are bit-identical to the reference's on the same f32 input.

int4 is stored packed, two nibbles per byte along one axis (the last,
unless `dim` says otherwise): the even index goes to the low nibble.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _axes(x: torch.Tensor, reduce_axes: int | Sequence[int]) -> list[int]:
    axes = [reduce_axes] if isinstance(reduce_axes, int) else list(reduce_axes)
    return [a % x.ndim for a in axes]


def _symmetric(x: torch.Tensor, reduce_axes, levels: int):
    xf = x.float()
    amax = xf.abs().amax(dim=_axes(x, reduce_axes), keepdim=True)
    scale = torch.where(amax > 0, amax / float(levels),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -levels, levels).to(torch.int8)
    return q, scale


def symmetric_int8(x: torch.Tensor, reduce_axes) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """(q, scale): int8 codes in [-127, 127] and the f32 scale (amax/127,
    1 where amax is 0), shared over `reduce_axes`, which the scale keeps
    as size 1; q * scale ~= x within scale/2 per element."""
    return _symmetric(x, reduce_axes, 127)


def symmetric_int4(x: torch.Tensor, reduce_axes) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Unpacked int4: int8 codes in [-7, 7], scale amax/7."""
    return _symmetric(x, reduce_axes, 7)


def pack_int4(q: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """int4 values (int8 in [-8, 7]) packed pairwise along `dim` into
    uint8: even index -> low nibble, odd -> high. `dim` must be even."""
    dim %= q.ndim
    if q.shape[dim] % 2:
        raise ValueError(
            f"pack_int4 needs an even axis {dim}, got shape {tuple(q.shape)}")
    pairs = q.unflatten(dim, (q.shape[dim] // 2, 2))
    lo = (pairs.select(dim + 1, 0) & 0xF).to(torch.uint8)
    hi = (pairs.select(dim + 1, 1) & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of pack_int4: uint8 -> int8 in [-8, 7], `dim` twice as
    long; each nibble is sign-extended (8..15 are -8..-1)."""
    dim %= packed.ndim
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=dim + 1).flatten(dim, dim + 1)
