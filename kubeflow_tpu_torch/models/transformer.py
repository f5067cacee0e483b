"""Decoder-only transformer LM, training path (port of
kubeflow_tpu/models/transformer.py).

Pre-RMSNorm, rotary embeddings (half-split), grouped-query attention,
SwiGLU, an untied head with f32 logits. Parameters are stored in f32 and
cast to the model dtype at use, as flax's `DenseGeneral(dtype=...)` does;
module and parameter names follow the flax tree (`layer_3.attn.q`,
`lm_head.kernel`), so `convert.py` maps one onto the other.

`remat` rematerializes per block under the reference's policies (full,
dots, mlp, slim, and `<policy>@K` for the first K blocks); see
`Block.forward`. The decode branches, ring/Ulysses attention, MoE and
pipeline stages are not ported yet and raise NotImplementedError naming
their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.registry import register_model
from kubeflow_tpu_torch.ops import flash_attention
from kubeflow_tpu_torch.ops.attention import attention
from kubeflow_tpu_torch.ops.xent import head_logits


def as_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    got = getattr(torch, str(dtype), None)
    if not isinstance(got, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return got


REMAT_POLICIES = ("full", "dots", "mlp", "slim")


def _split_policy(policy: str) -> tuple[str, int | None]:
    """'slim@12' -> ('slim', 12): the named policy on the first 12 blocks,
    everything saved on the rest; a plain name -> (name, None), every
    block (the reference's _split_policy)."""
    if "@" in policy:
        name, k = policy.split("@", 1)
        if not name or not k.isdigit():
            raise ValueError(
                f"malformed remat_policy {policy!r}: expected "
                "'<dots|full|mlp|slim>@<layer count>' (e.g. slim@12)")
        return name, int(k)
    return policy, None


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and defaults as the reference's TransformerConfig, so
    `model_kwargs` dicts load unchanged. `dtype` takes a torch dtype or
    its name."""

    vocab_size: int = 32000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 2048
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    attention_impl: str = "auto"   # auto | flash | reference (ring, ulysses: later)
    flash_block_q: int = 0
    flash_block_k: int = 0
    kv_cache_dtype: str = "auto"
    attention_window: int = 0
    rolling_kv_cache: bool = False
    kv_pages: int = 0
    kv_page_size: int = 0
    remat: bool = False
    remat_policy: str = "full"
    moe_every: int = 0
    n_experts: int = 8
    expert_top_k: int = 2
    moe_impl: str = "auto"
    moe_capacity_factor: float = 1.25
    pipeline_stages: int = 0
    pp_microbatches: int = 4

    def __post_init__(self) -> None:
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        if self.remat:
            # the reference's checks, in its order and with its messages
            name, k = _split_policy(self.remat_policy)
            if k is not None and not 0 < k <= self.n_layers:
                raise ValueError(
                    f"remat_policy {self.remat_policy!r}: layer count "
                    f"must be in 1..{self.n_layers}")
            if name not in REMAT_POLICIES:
                raise ValueError(
                    f"unknown remat_policy {self.remat_policy!r} "
                    "(full|dots|mlp|slim)")
        if self.moe_every:
            raise NotImplementedError(
                "MoE blocks are not ported yet (ROADMAP Queue 1 item 18)")
        if self.pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline stages are not ported yet (ROADMAP Queue 1 item 18)")
        if self.attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"{self.attention_impl} attention is not ported yet (ROADMAP "
                "Queue 1 item 18)")


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding over the last dim, half-split (not
    interleaved). x: [B, L, H, D]; positions [B, L]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs          # [B, L, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm in f32 with an f32 scale, then cast to the model dtype."""

    def __init__(self, dim: int, dtype: torch.dtype, device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + self.eps)
        return (y * self.scale).to(self.dtype)


class Dense(nn.Module):
    """Bias-free projection: f32 weight [out, in], applied in `dtype`."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        d, hd, dt = cfg.d_model, cfg.head_dim, cfg.dtype
        self.q = Dense(d, cfg.n_heads * hd, dt, device)
        self.k = Dense(d, cfg.n_kv_heads * hd, dt, device)
        self.v = Dense(d, cfg.n_kv_heads * hd, dt, device)
        self.o = Dense(cfg.n_heads * hd, d, dt, device)

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        b, l, _ = x.shape
        q = rope(self.q(x).view(b, l, cfg.n_heads, cfg.head_dim), positions,
                 cfg.rope_theta)
        k = rope(self.k(x).view(b, l, cfg.n_kv_heads, cfg.head_dim),
                 positions, cfg.rope_theta)
        v = self.v(x).view(b, l, cfg.n_kv_heads, cfg.head_dim)
        out = attention(q, k, v, causal=True, impl=cfg.attention_impl,
                        segment_ids=segment_ids, block_q=cfg.flash_block_q,
                        block_k=cfg.flash_block_k,
                        window=cfg.attention_window)
        return self.o(out.reshape(b, l, cfg.n_heads * cfg.head_dim))


class SwiGLU(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        dt = cfg.dtype
        self.gate = Dense(cfg.d_model, cfg.d_ff, dt, device)
        self.up = Dense(cfg.d_model, cfg.d_ff, dt, device)
        self.down = Dense(cfg.d_ff, cfg.d_model, dt, device)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LMHead(nn.Module):
    """Vocab projection: operands in the model dtype, f32 logits. The
    kernel is [d_model, vocab] f32, as the reference's lm_head/kernel."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.dtype = cfg.dtype
        self.kernel = nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, device=device))

    def forward(self, x):
        return head_logits(x, self.kernel, self.dtype)


def _save_dots(ctx, func, *args, **kwargs):
    """The `dots` policy: matmul outputs without batch dims, and the flash
    forward's (out, lse), which the reference names `attn_flash` so that
    its dots policy saves them too."""
    if func in (torch.ops.aten.mm.default,
                flash_attention.flash_fwd._opoverload):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def _replayed(fn, *args):
    """fn(*args), saving only args: its intermediates are recomputed in
    the backward."""
    return checkpoint(fn, *args, use_reentrant=False)


def _direct(fn, *args):
    return fn(*args)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.mlp = SwiGLU(cfg, device)

    def forward(self, x, positions, segment_ids=None, remat=None):
        """One block; `remat` names the policy that decides what the
        backward keeps (None: whatever autograd saves). Each keeps the
        block's input x, and:
        - full: nothing else. The block replays, the flash forward
          included.
        - dots: the matmul outputs and the flash forward's (out, lse),
          by selective checkpointing; the elementwise work replays.
        - mlp: all but the d_ff-wide work (an op with an input whose
          last dim is d_ff): gate, up and their product replay from the
          saved ln_mlp output.
        - slim: the reference's anchors: the two norm outputs
          (block_norm), q, k and v after rope (attn_qkv), the attention
          output before o (attn_ctx) and the flash (out, lse)
          (attn_flash). They are the inputs of checkpointed sub-regions:
          each norm replays from its input (x, and the stream after
          attention), the SwiGLU from ln_mlp, and the attention half
          saves what its backward needs (the anchors, the bf16 weights,
          rope's cos/sin), so neither the flash forward nor a q/k/v/o
          matmul replays.
        A replay stops once it has rebuilt what the backward needs, so
        the down projection never replays. Remat changes what is saved,
        never a value."""
        if remat in ("full", "dots"):
            extra = {"context_fn": _dots_contexts} if remat == "dots" else {}
            return checkpoint(self._body, x, positions, segment_ids, None,
                              use_reentrant=False, **extra)
        return self._body(x, positions, segment_ids, remat)

    def _body(self, x, positions, segment_ids, remat):
        norm = _replayed if remat == "slim" else _direct
        mlp = _replayed if remat in ("mlp", "slim") else _direct
        x = x + self.attn(norm(self.ln_attn, x), positions, segment_ids)
        return x + mlp(self.mlp, norm(self.ln_mlp, x))


class TransformerLM(nn.Module):
    """The LM. Built on `device` (cuda unless "cpu" is asked for) with
    weights drawn from `seed` by the reference's initializers: normal(1.0)
    embedding, normal(0.02) projections and head, unit norm scales."""

    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, device=dev))
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", Block(cfg, dev))
        self.ln_f = RMSNorm(cfg.d_model, cfg.dtype, dev)
        self.lm_head = LMHead(cfg, dev)
        if dev.type == "meta":          # shapes only: nothing to draw
            return
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("scale"):
                    continue
                std = 1.0 if name == "embedding" else 0.02
                p.normal_(0.0, std, generator=gen)

    def blocks(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layers)]

    def forward(self, tokens, segment_ids=None, decode_index=None,
                return_hidden: bool = False):
        """tokens [B, L] -> f32 logits [B, L, V], or the final-norm hidden
        states [B, L, d] with return_hidden (the chunked-loss path)."""
        if decode_index is not None:
            raise NotImplementedError(
                "KV-cache decode is not ported yet (ROADMAP Queue 1, "
                "slice 2, item 7)")
        cfg = self.cfg
        x = F.embedding(tokens, self.embedding.to(cfg.dtype))
        positions = torch.arange(tokens.shape[1], device=tokens.device
                                 ).expand(tokens.shape)
        policy, k_mix = (_split_policy(cfg.remat_policy) if cfg.remat
                         else (None, None))
        for i, blk in enumerate(self.blocks()):
            # policy@K: the first K blocks remat, the rest save everything
            remat = policy if k_mix is None or i < k_mix else None
            x = blk(x, positions, segment_ids, remat)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return self.lm_head(x)

    def flops_per_token(self, seq_len: int | None = None) -> float:
        return flops_per_token(self.cfg, seq_len)


def flops_per_token(cfg: TransformerConfig, seq_len: int | None = None) -> float:
    """Train FLOPs per token: 6*N over the dense params, plus the
    attention score/value matmuls (12*h*d_head*T per layer, halved for
    causal masking) when seq_len is given."""
    attn = cfg.d_model * cfg.head_dim * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    mlp = 3 * cfg.d_model * cfg.d_ff
    n_moe = (cfg.n_layers // cfg.moe_every) if cfg.moe_every else 0
    n_dense = cfg.n_layers - n_moe
    moe = cfg.expert_top_k * mlp + cfg.d_model * cfg.n_experts
    emb = cfg.vocab_size * cfg.d_model
    flops = 6.0 * (cfg.n_layers * attn + n_dense * mlp + n_moe * moe
                   + 2 * emb)
    if seq_len:
        flops += 12.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq_len / 2
    return flops


def _build(device=None, seed: int = 0, **overrides) -> TransformerLM:
    fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    unknown = set(overrides) - fields
    if unknown:
        raise ValueError(f"unknown transformer kwargs {sorted(unknown)}")
    return TransformerLM(TransformerConfig(**overrides), device=device,
                         seed=seed)


def _registered(name: str, base: dict) -> None:
    @register_model(name)
    def build(device=None, seed: int = 0, **kw) -> TransformerLM:
        return _build(device=device, seed=seed, **{**base, **kw})


# the reference's registered transformer configs, by registry name
CONFIGS = {
    "transformer-test": dict(vocab_size=256, d_model=64, n_layers=2,
                             n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                             max_seq_len=256),
    "gpt-125m": dict(d_model=768, n_layers=12, n_heads=12, n_kv_heads=12,
                     head_dim=64, d_ff=3072),
    "gpt-350m": dict(d_model=1024, n_layers=24, n_heads=16, n_kv_heads=16,
                     head_dim=64, d_ff=4096),
    "gpt-760m": dict(d_model=1536, n_layers=24, n_heads=24, n_kv_heads=24,
                     head_dim=64, d_ff=6144),
    "llama-1b": dict(d_model=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                     head_dim=64, d_ff=8192),
    "llama-1b-hd128": dict(d_model=2048, n_layers=16, n_heads=16,
                           n_kv_heads=4, head_dim=128, d_ff=8192),
}
for _name, _base in CONFIGS.items():
    _registered(_name, _base)
