"""BERT-style bidirectional encoder (port of kubeflow_tpu/models/bert.py):
bert-test, bert-base.

tokens [B, L] -> the embedding gather (table from normal(1.0)) plus the
position table, both cast to the model dtype; pre-norm encoder blocks
(`models/encoder.py`) whose attention masks by the padding as the
reference does: segment ids `tokens != 0`, so pads attend to pads and
tokens to tokens (not a key-padding mask); a final RMSNorm; [CLS]
pooling at position 0 in f32 and an f32 classifier head. Attention is
the plain `reference_attention`; `attention_impl="ring"` is the
bidirectional ring (ops/ring_attention.py) with no padding mask, as the
reference's long-context path: over the `seq` group when one is set
(`BertEncoder.seq`, this rank's tokens a block of positions; the [CLS]
row comes from the group's first rank), else the plain attention.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
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


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    num_classes: int = 2
    dtype: Any = torch.bfloat16
    attention_impl: str = "reference"

    def __post_init__(self) -> None:
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        if self.attention_impl not in ("reference", "ring"):
            raise ValueError(f"unknown attention_impl "
                             f"{self.attention_impl!r} (reference | ring)")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class BertEncoder(nn.Module):
    """Built on `device` (cuda unless "cpu" is asked for) with weights
    from `seed`: normal(1.0) embedding, normal(0.02) position table and
    projections, a lecun-normal head, zero biases, unit norm scales."""

    def __init__(self, cfg: BertConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.seq = None          # the seq axis' AxisGroup (ring)
        dev = resolve_device(device)
        self.embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, device=dev))
        self.pos_embedding = nn.Parameter(
            torch.empty(cfg.max_seq_len, cfg.d_model, device=dev))
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderBlock(
                cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.dtype, dev))
        self.ln_f = RMSNorm(cfg.d_model, cfg.dtype, dev)
        # flax nn.Dense(dtype=float32)
        self.head = Dense(cfg.d_model, cfg.num_classes, torch.float32, dev,
                          bias=True)
        if dev.type != "meta":
            gen = torch.Generator(device=dev).manual_seed(seed)
            lecun = (1.0 / cfg.d_model) ** 0.5 / .87962566103423978
            init_normal(self, gen, {"embedding": 1.0, "head.weight": 0.0})
            with torch.no_grad():
                nn.init.trunc_normal_(self.head.weight, 0.0, lecun,
                                      -2 * lecun, 2 * lecun, generator=gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        l = tokens.shape[1]
        start = self.seq.rank * l if self.seq is not None else 0
        x = (F.embedding(tokens, gathered(self, "embedding").to(cfg.dtype))
             + self.pos_embedding[start:start + l].to(cfg.dtype))
        ring = cfg.attention_impl == "ring"
        # the padding mask as segment ids (token 0 is [PAD]); the ring
        # attends over everything
        seg = None if ring else (tokens != 0).to(torch.int32)
        for blk in self.blocks():
            x = blk(x, seg, ring, self.seq)
        x = self.ln_f(x)
        # [CLS] pooling (position 0) -> classifier, f32
        cls = x[:, 0]
        if self.seq is not None:
            cls = _FromFirst.apply(cls, self.seq.group, self.seq.rank)
        return self.head(cls)

    def blocks(self) -> list[EncoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layers)]

    def flops_per_token(self, seq_len: int | None = None) -> float:
        """Train FLOPs per token (2*MAC, 6*N plus the unhalved
        bidirectional attention term), the reference's count."""
        cfg = self.cfg
        per_layer = 4 * cfg.d_model * cfg.d_model + 2 * cfg.d_model * cfg.d_ff
        flops = 6.0 * cfg.n_layers * per_layer
        if seq_len:
            flops += 12.0 * cfg.n_layers * cfg.d_model * seq_len
        return flops


class _FromFirst(torch.autograd.Function):
    """The first rank's x on every rank of the group; the backward sums
    the gradients onto the first rank (the adjoint of a broadcast)."""

    @staticmethod
    def forward(ctx, x, group, rank):
        import torch.distributed as dist

        ctx.group, ctx.rank = group, rank
        x = x.clone() if rank == 0 else torch.zeros_like(x)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return (g if ctx.rank == 0 else torch.zeros_like(g)), None, None


def _build(device=None, seed: int = 0, **kw) -> BertEncoder:
    fields = {f.name for f in dataclasses.fields(BertConfig)}
    unknown = set(kw) - fields
    if unknown:
        raise ValueError(f"unknown bert kwargs {sorted(unknown)}")
    return BertEncoder(BertConfig(**kw), device=device, seed=seed)


@register_model("bert-test")
def bert_test(device=None, seed: int = 0, **kw) -> BertEncoder:
    base = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                max_seq_len=128, num_classes=2)
    return _build(device, seed, **{**base, **kw})


@register_model("bert-base")
def bert_base(device=None, seed: int = 0, **kw) -> BertEncoder:
    return _build(device, seed, **kw)
