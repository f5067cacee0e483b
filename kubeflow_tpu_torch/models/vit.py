"""Vision Transformer for image classification (port of
kubeflow_tpu/models/vit.py): vit-test, vit-s16, vit-b16.

images [B, H, W, 3] f32 -> patches [B, n, p*p*3] (a reshape and a
transpose), one projection to d_model, an f32 position table cast to the
model dtype before the add, pre-norm encoder blocks (`models/encoder.py`),
a final RMSNorm, the mean over patches, and a bf16 head GEMM with f32
logits out (`ops/xent.py` head_logits, as the LM head: not a bf16 result
cast up). Attention is the plain `reference_attention`, as in the
reference; the flash kernels are not on this path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.encoder import EncoderBlock, init_normal
from kubeflow_tpu_torch.models.registry import register_model
from kubeflow_tpu_torch.models.transformer import (
    Dense,
    RMSNorm,
    as_dtype,
    gathered,
)
from kubeflow_tpu_torch.ops.xent import head_logits


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    d_model: int = 384
    n_layers: int = 12
    n_heads: int = 6
    d_ff: int = 1536
    num_classes: int = 1000
    dtype: Any = torch.bfloat16

    def __post_init__(self) -> None:
        object.__setattr__(self, "dtype", as_dtype(self.dtype))

    @property
    def n_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class ViT(nn.Module):
    """Built on `device` (cuda unless "cpu" is asked for) with weights
    from `seed`: normal(0.02) kernels and position table, zero biases and
    a zero head, unit norm scales (the reference's initializers)."""

    def __init__(self, cfg: ViTConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        dt = cfg.dtype
        self.patch_embed = Dense(cfg.patch_size ** 2 * 3, cfg.d_model, dt,
                                 dev, bias=True)
        self.pos_embed = nn.Parameter(
            torch.empty(cfg.n_patches, cfg.d_model, device=dev))
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderBlock(
                cfg.d_model, cfg.n_heads, cfg.d_ff, dt, dev))
        self.ln_f = RMSNorm(cfg.d_model, dt, dev)
        self.head_kernel = nn.Parameter(
            torch.zeros(cfg.d_model, cfg.num_classes, device=dev))
        if dev.type != "meta":
            init_normal(self, torch.Generator(device=dev).manual_seed(seed),
                        {"head_kernel": 0.0})

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = images.shape[0]
        p, side = cfg.patch_size, cfg.image_size // cfg.patch_size
        if tuple(images.shape[1:]) != (cfg.image_size, cfg.image_size, 3):
            raise ValueError(f"ViT configured for {cfg.image_size}px RGB, "
                             f"got {tuple(images.shape)}")
        x = images.to(cfg.dtype).reshape(b, side, p, side, p, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, side * side, p * p * 3)
        x = (self.patch_embed(x)
             + gathered(self, "pos_embed").to(cfg.dtype)[None])
        for blk in self.blocks():
            x = blk(x)
        x = self.ln_f(x).mean(dim=1)           # GAP over patches
        return head_logits(x, gathered(self, "head_kernel"), cfg.dtype)

    def blocks(self) -> list[EncoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layers)]

    def fwd_flops_per_image(self) -> float:
        """2*MAC forward FLOPs (the MFU meter's convention)."""
        cfg = self.cfg
        n, d = cfg.n_patches, cfg.d_model
        per_block = (2 * n * d * (3 * d)            # qkv
                     + 2 * n * n * d * 2            # scores + values
                     + 2 * n * d * d                # out proj
                     + 2 * n * d * cfg.d_ff * 2)    # fc1 + fc2
        embed = 2 * n * (cfg.patch_size ** 2 * 3) * d
        head = 2 * d * cfg.num_classes
        return float(cfg.n_layers * per_block + embed + head)


def _build(device=None, seed: int = 0, **kw) -> ViT:
    fields = {f.name for f in dataclasses.fields(ViTConfig)}
    unknown = set(kw) - fields
    if unknown:
        raise ValueError(f"unknown vit kwargs {sorted(unknown)}")
    return ViT(ViTConfig(**kw), device=device, seed=seed)


@register_model("vit-test")
def vit_test(device=None, seed: int = 0, **kw) -> ViT:
    base = dict(image_size=32, patch_size=8, d_model=32, n_layers=2,
                n_heads=2, d_ff=64, num_classes=10)
    return _build(device, seed, **{**base, **kw})


@register_model("vit-s16")
def vit_s16(device=None, seed: int = 0, **kw) -> ViT:
    """ViT-S/16 (22M parameters)."""
    return _build(device, seed, **kw)


@register_model("vit-b16")
def vit_b16(device=None, seed: int = 0, **kw) -> ViT:
    base = dict(d_model=768, n_layers=12, n_heads=12, d_ff=3072)
    return _build(device, seed, **{**base, **kw})
