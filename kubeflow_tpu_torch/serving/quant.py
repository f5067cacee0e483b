"""Weight-only int8/int4 quantization for serving (port of
kubeflow_tpu/serving/quant.py).

Every floating parameter with ndim >= 2 and at least `min_size`
elements is stored as int8 codes (or int4, two per byte) with an f32
scale, and dequantized to bf16 at each forward (`QuantizedModel`); norm
scales and small leaves stay exact. Matmul weights scale per output
channel, the embedding per row (its rows are looked up one by one).

The reduce axes are the flax tree's, not torch's: q/k/v [d, H, D] share
one scale per D index over all heads, o [H, D, d] one per d, lm_head
[d, V] one per V. Each weight is therefore quantized in its flax view
(`convert.flax_layout`), so codes and scales are bit-identical to the
reference's; they are stored in the port's memory order, so that
dequantizing is one multiply and one cast with no transpose.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from kubeflow_tpu_torch.convert import flax_layout
from kubeflow_tpu_torch.ops.quantize import (
    pack_int4,
    symmetric_int4,
    symmetric_int8,
    unpack_int4,
)


@dataclasses.dataclass
class QTensor:
    """One quantized parameter. `codes` (int8, or uint8 with two int4
    codes per byte along view axis `pack_dim`) and `scale` (f32, size 1
    on the reduced axes) are laid out in `view`, the port parameter's
    memory order; `.permute(perm)` of either is the flax layout."""

    kind: str                    # "int8" | "int4"
    codes: torch.Tensor
    scale: torch.Tensor
    shape: tuple[int, ...]       # the port parameter's shape
    perm: tuple[int, ...]
    pack_dim: int

    def flax_codes(self) -> torch.Tensor:
        return self.codes.permute(self.perm)

    def flax_scale(self) -> torch.Tensor:
        return self.scale.permute(self.perm)

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        """(unpack,) codes * scale in f32, cast to `dtype`, in the port
        parameter's shape."""
        q = (unpack_int4(self.codes, self.pack_dim) if self.kind == "int4"
             else self.codes)
        return (q * self.scale).to(dtype).view(self.shape)

    @property
    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scale.numel() * self.scale.element_size())


def quantize_params(params: dict[str, torch.Tensor], head_dim: int,
                    min_size: int = 4096, bits: int = 8) -> dict[str, Any]:
    """name -> QTensor for each floating parameter with ndim >= 2 and
    >= min_size elements, the rest as they are. bits 4 packs pairs along
    the flax layout's last axis; a weight whose last axis is odd falls
    back to int8."""
    if bits not in (4, 8):
        raise ValueError(f"quantize_params bits must be 4 or 8, got {bits}")
    out: dict[str, Any] = {}
    for name, x in params.items():
        if not (x.is_floating_point() and x.ndim >= 2
                and x.numel() >= min_size):
            out[name] = x
            continue
        view, perm = flax_layout(name, x.shape, head_dim)
        xv = x.detach().reshape(view)
        n = len(view)
        flax_axes = range(1, n) if name == "embedding" else range(n - 1)
        axes = [perm[a] for a in flax_axes]      # flax axis a is view perm[a]
        last = perm[-1]
        if bits == 4 and view[last] % 2 == 0:
            q, scale = symmetric_int4(xv, axes)
            out[name] = QTensor("int4", pack_int4(q, last), scale,
                                tuple(x.shape), tuple(perm), last)
        else:
            q, scale = symmetric_int8(xv, axes)
            out[name] = QTensor("int8", q, scale, tuple(x.shape),
                                tuple(perm), last)
    return out


def dequantize_params(params: dict[str, Any],
                      dtype: torch.dtype = torch.bfloat16
                      ) -> dict[str, torch.Tensor]:
    """Every QTensor dequantized to `dtype`; other leaves as they are."""
    return {name: p.dequantize(dtype) if isinstance(p, QTensor) else p
            for name, p in params.items()}


class QuantizedModel:
    """A model whose `apply` takes quantized params and dequantizes them
    at every call, then runs the wrapped model on the result: generate(),
    the slot decoder and the server use only `apply`, `cfg` and
    `device`, so they need no change for quantized weights."""

    def __init__(self, model, dtype: torch.dtype = torch.bfloat16):
        self._model = model
        self._dtype = dtype

    @property
    def cfg(self):
        return self._model.cfg

    @property
    def device(self) -> torch.device:
        return self._model.device

    def apply(self, params, *args, **kwargs):
        return self._model.apply(dequantize_params(params, self._dtype),
                                 *args, **kwargs)
