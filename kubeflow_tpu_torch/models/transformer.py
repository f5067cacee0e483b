"""Decoder-only transformer LM, training and decode (port of
kubeflow_tpu/models/transformer.py).

Pre-RMSNorm, rotary embeddings (half-split), grouped-query attention,
SwiGLU, an untied head with f32 logits. Parameters are stored in f32 and
cast to the model dtype at use, as flax's `DenseGeneral(dtype=...)` does;
module and parameter names follow the flax tree (`layer_3.attn.q`,
`lm_head.kernel`), so `convert.py` maps one onto the other.

`remat` rematerializes per block under the reference's policies (full,
dots, mlp, slim, and `<policy>@K` for the first K blocks); see
`Block.forward`.

Decode (`forward(..., decode_index=, cache=)`) runs the reference's
KV-cache paths: the dense cache (scalar, per-row and per-row chunk
writes), its int8 variant with the scales applied to the scores and
folded into the probabilities, the rolling-window cache (W slots,
attend then write), and the paged pool with page 0 as the trash page.
The cache is explicit state, a flat dict of per-layer tensors under the
flax names (`layer_3/attn/cached_key`), written in place.

Every `moe_every`-th block (`(i + 1) % moe_every == 0`, the reference's
indexing) runs `ops/moe.py`'s MoEBlock in place of the SwiGLU, in
training and decode alike. Sequence parallelism: with `seq` set (a
mesh.AxisGroup, by the trainer) the tokens are this rank's block of
positions, RoPE takes their global positions, and `attention_impl`
ring or ulysses exchanges K/V or heads over the group
(`ops/ring_attention.py`, `ops/ulysses.py`); without it both run on
the whole sequence, ring as the plain reference attention and Ulysses
as the local dispatch. Pipeline stages (`pipeline_stages > 1`) are run
by `parallel/pipeline.py`, which calls `embed`, `run_blocks` and
`head` per stage; the model keeps the sequential layer names.
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
from kubeflow_tpu_torch.ops.attention import NEG_FILL, attention
from kubeflow_tpu_torch.ops.quantize import symmetric_int8
from kubeflow_tpu_torch.ops.xent import chunked_lm_xent, head_logits


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
    attention_impl: str = "auto"   # auto | flash | reference | ring | ulysses
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


def _identity(x):
    return x


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
    """Projection: f32 weight [out, in] (and an f32 bias with `bias`),
    applied in `dtype`."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device,
                 bias: bool = False):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = (nn.Parameter(torch.zeros(d_out, device=device))
                     if bias else None)

    def forward(self, x):
        return F.linear(x.to(self.dtype),
                        gathered(self, "weight").to(self.dtype),
                        None if self.bias is None else self.bias.to(self.dtype))


def gathered(module: nn.Module, leaf: str) -> torch.Tensor:
    """`module`'s parameter `leaf`, whole: all-gathered over the model
    group where tensor parallelism keeps a slice of it for storage only
    (`module.gathers`, set by parallel/shardings.py)."""
    w = getattr(module, leaf)
    fns = module.__dict__.get("gathers")
    return w if not fns or leaf not in fns else fns[leaf](w)


@dataclasses.dataclass
class Decode:
    """One decode call's arguments, shared by every layer. `index` is a
    Python int (the whole batch starts there) or a [B] long tensor (one
    start per row); `cache` is the flat dict the layers write into."""

    index: int | torch.Tensor
    pad_len: torch.Tensor | None
    page_table: torch.Tensor | None
    cache: dict[str, torch.Tensor]


def rolling_window(cfg: TransformerConfig) -> int:
    """W, the positions a rolling cache keeps: min(window, max_seq).
    Refuses a rolling cache without a window, as the reference does."""
    if not cfg.attention_window:
        raise ValueError("rolling_kv_cache requires attention_window > 0")
    return min(cfg.attention_window, cfg.max_seq_len)


def decode_cache_shapes(cfg: TransformerConfig, batch: int,
                        kv_heads: int | None = None
                        ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Shape and dtype of each dense decode-cache tensor, by flax name:
    [B, S, Hkv, D] keys and values in the model dtype, or int8 codes
    plus f32 [B, S, Hkv, 1] scales under kv_cache_dtype int8. S is
    max_seq, or W (`rolling_window`) for the rolling cache; Hkv is
    `kv_heads` (a rank's under tensor parallelism,
    `TransformerLM.cache_kv_heads`), else the config's."""
    s = rolling_window(cfg) if cfg.rolling_kv_cache else cfg.max_seq_len
    if cfg.kv_cache_dtype not in ("auto", "int8"):
        raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r} "
                         "(auto|int8)")
    quant = cfg.kv_cache_dtype == "int8"
    hkv = cfg.n_kv_heads if kv_heads is None else kv_heads
    kv = (batch, s, hkv, cfg.head_dim)
    leaves = {"cached_key": (kv, torch.int8 if quant else cfg.dtype),
              "cached_value": (kv, torch.int8 if quant else cfg.dtype)}
    if quant:
        sc = (batch, s, hkv, 1)
        leaves.update(cached_key_scale=(sc, torch.float32),
                      cached_value_scale=(sc, torch.float32))
    return {f"layer_{i}/attn/{k}": v for i in range(cfg.n_layers)
            for k, v in leaves.items()}


def paged_cache_shapes(cfg: TransformerConfig
                       ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The paged pool: [kv_pages, kv_page_size, Hkv, D] keys and values
    per layer, in the model dtype."""
    if not (cfg.kv_pages and cfg.kv_page_size):
        raise ValueError("the model was built without kv_pages/kv_page_size")
    pool = ((cfg.kv_pages, cfg.kv_page_size, cfg.n_kv_heads, cfg.head_dim),
            cfg.dtype)
    return {f"layer_{i}/attn/{k}": pool for i in range(cfg.n_layers)
            for k in ("key_pages", "value_pages")}


def _kv_scale_rows(s: torch.Tensor) -> torch.Tensor:
    """[B, S, Hkv, 1] int8-cache scales -> [B, Hkv, 1, 1, S], which
    broadcasts against the [B, Hkv, G, Lq, S] scores and probabilities."""
    return s[..., 0].transpose(1, 2)[:, :, None, None, :]


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched with f32 out (the reference's
    preferred_element_type=float32): a 16-bit GEMM with f32 output on the
    card, the exact products of the operands summed in f32 elsewhere."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _write_rows(buf: torch.Tensor, new: torch.Tensor, idx) -> None:
    """Write the chunk `new` [B, Lq, ...] into `buf` [B, S, ...] at
    positions idx.. in place, with the reference's out-of-range rules:
    a scalar start is shifted so the chunk fits (dynamic_update_slice);
    a per-row position past the end is dropped (its one-hot matches no
    column)."""
    s, lq = buf.shape[1], new.shape[1]
    if isinstance(idx, int):
        start = min(max(idx, 0), s - lq)
        buf[:, start:start + lq] = new
        return
    rows = torch.arange(buf.shape[0], device=buf.device)
    if lq == 1:
        at = idx.clamp(0, s - 1)
        valid = ((idx >= 0) & (idx < s)).view(-1, *[1] * (new.ndim - 2))
        buf[rows, at] = torch.where(valid, new[:, 0], buf[rows, at])
        return
    # per-row chunk: column s takes chunk row s - idx[b] where that row
    # exists (the rows of one slot land at distinct columns)
    c = torch.arange(s, device=buf.device)[None, :] - idx[:, None]
    hit = (c >= 0) & (c < lq)
    pick = c.clamp(0, lq - 1).view(*c.shape, *[1] * (new.ndim - 2))
    upd = torch.gather(new, 1, pick.expand(-1, -1, *new.shape[2:]))
    hit = hit.view(*hit.shape, *[1] * (new.ndim - 2))
    buf.copy_(torch.where(hit, upd, buf))


def _grouped_scores(q: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """f32 scores of q [B, Lq, H, D] against keys [B, S, Hkv, D], scaled
    by D^-0.5, as [B, Hkv, G, Lq, S]: the query heads grouped per kv
    head, so k is never repeated."""
    b, lq, h, d = q.shape
    s, hkv = keys.shape[1], keys.shape[2]
    g = h // hkv
    qg = q.reshape(b, lq, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b * hkv, g * lq, d)
    kt = keys.permute(0, 2, 3, 1).reshape(b * hkv, d, s)
    return _bmm_f32(qg, kt).view(b, hkv, g, lq, s) * (d ** -0.5)


def _grouped_mix(probs: torch.Tensor, vals: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """probs [B, Hkv, G, Lq, S] (cast to `dtype`) times vals
    [B, S, Hkv, D] -> [B, Hkv, G, Lq, D]."""
    b, hkv, g, lq, s = probs.shape
    d = vals.shape[-1]
    vt = vals.permute(0, 2, 1, 3).reshape(b * hkv, s, d)
    out = torch.bmm(probs.to(dtype).reshape(b * hkv, g * lq, s), vt)
    return out.view(b, hkv, g, lq, d)


def _ungroup(out: torch.Tensor) -> torch.Tensor:
    """[B, Hkv, G, Lq, D] -> [B, Lq, H, D]."""
    b, hkv, g, lq, d = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, hkv * g, d)


def cache_attention(q, k_all, v_all, qpos, pad_len, window: int,
                    dtype: torch.dtype, k_scale=None, v_scale=None):
    """Masked attention of q [B, Lq, H, D] over a cache view k_all/v_all
    [B, S, Hkv, D]. The query heads are grouped per kv head (k and v are
    never repeated); scores are f32; `qpos` [B or 1, Lq] is each query's
    absolute position, and a key at position s is seen where s <= qpos,
    s > qpos - window (window > 0) and s >= pad_len. The fill is -1e30.
    With an int8 cache, k_scale/v_scale ([B, Hkv, 1, 1, S]) multiply
    the scores and fold into the probabilities."""
    logits = _grouped_scores(q, k_all)
    if k_scale is not None:
        logits = logits * k_scale
    pos = torch.arange(k_all.shape[1], device=q.device)
    qp = qpos[:, None, None, :, None]
    mask = pos <= qp
    if window:
        mask = mask & (pos > qp - window)
    if pad_len is not None:
        mask = mask & (pos >= pad_len[:, None, None, None, None])
    probs = torch.softmax(torch.where(mask, logits, NEG_FILL), dim=-1)
    if v_scale is not None:
        probs = probs * v_scale
    return _ungroup(_grouped_mix(probs, v_all, dtype))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, cache_prefix: str = ""):
        super().__init__()
        self.cfg = cfg
        self.cache_prefix = cache_prefix     # "layer_3/attn/"
        d, hd, dt = cfg.d_model, cfg.head_dim, cfg.dtype
        self.q = Dense(d, cfg.n_heads * hd, dt, device)
        self.k = Dense(d, cfg.n_kv_heads * hd, dt, device)
        self.v = Dense(d, cfg.n_kv_heads * hd, dt, device)
        self.o = Dense(cfg.n_heads * hd, d, dt, device)
        # tensor parallelism (parallel/shardings.py): the input's and the
        # output's collectives, and the kv heads this rank's q heads use
        # when the k/v projections replicate; the head counts are those
        # of the (local) weights, split `model_size` ways
        self.tp_in = self.tp_out = _identity
        self.kv_heads: list[int] | None = None
        self.model_size = 1
        # the seq axis' AxisGroup: ring and ulysses exchange over it, the
        # local impls gather K/V over it (ops/seq_attention.py)
        self.seq = None

    def forward(self, x, positions, segment_ids=None, decode=None):
        cfg = self.cfg
        b, l, _ = x.shape
        x = self.tp_in(x)
        q = rope(self.q(x).view(b, l, -1, cfg.head_dim), positions,
                 cfg.rope_theta)
        k = self.k(x).view(b, l, -1, cfg.head_dim)
        v = self.v(x).view(b, l, -1, cfg.head_dim)
        if self.kv_heads is not None:
            k, v = k[:, :, self.kv_heads], v[:, :, self.kv_heads]
        k = rope(k, positions, cfg.rope_theta)
        if decode is not None:
            out = self._decode(q, k, v, decode)
        elif cfg.attention_impl == "ring":
            from kubeflow_tpu_torch.ops.ring_attention import ring_attention

            out = ring_attention(q, k, v, seq=self.seq,
                                 segment_ids=segment_ids,
                                 window=cfg.attention_window)
        elif cfg.attention_impl == "ulysses":
            from kubeflow_tpu_torch.ops.ulysses import ulysses_attention

            out = ulysses_attention(q, k, v, seq=self.seq,
                                    segment_ids=segment_ids,
                                    block_q=cfg.flash_block_q,
                                    block_k=cfg.flash_block_k,
                                    window=cfg.attention_window,
                                    model_size=self.model_size)
        elif self.seq is not None:
            from kubeflow_tpu_torch.ops.seq_attention import seq_attention

            out = seq_attention(q, k, v, seq=self.seq, causal=True,
                                impl=cfg.attention_impl,
                                segment_ids=segment_ids,
                                block_q=cfg.flash_block_q,
                                block_k=cfg.flash_block_k,
                                window=cfg.attention_window)
        else:
            out = attention(q, k, v, causal=True, impl=cfg.attention_impl,
                            segment_ids=segment_ids,
                            block_q=cfg.flash_block_q,
                            block_k=cfg.flash_block_k,
                            window=cfg.attention_window)
        return self.tp_out(self.o(out.reshape(b, l, -1)))

    def _decode(self, q, k, v, dec: Decode):
        """Write this chunk's k/v into the cache, then attend over it
        (the reference's `Attention.__call__` decode branches)."""
        cfg = self.cfg
        if dec.page_table is not None:
            if not (cfg.kv_pages and cfg.kv_page_size):
                raise ValueError(
                    "page_table passed but the model was built without "
                    "kv_pages/kv_page_size")
            if cfg.rolling_kv_cache:
                raise ValueError(
                    "paged decode is exclusive with rolling_kv_cache "
                    "(the page pool already bounds cache memory)")
            if cfg.kv_cache_dtype != "auto":
                raise ValueError(
                    "paged decode supports kv_cache_dtype='auto' only "
                    "(int8 page pools are not composed yet)")
            return self._decode_paged(q, k, v, dec)
        if cfg.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r} "
                             "(auto|int8)")
        if cfg.rolling_kv_cache:
            return self._decode_rolling(q, k, v, dec, rolling_window(cfg))
        p, cache = self.cache_prefix, dec.cache
        ck, cv = cache[p + "cached_key"], cache[p + "cached_value"]
        quant = cfg.kv_cache_dtype == "int8"
        if quant:
            k_w, ks_w = symmetric_int8(k, -1)     # per (position, head)
            v_w, vs_w = symmetric_int8(v, -1)
            cks = cache[p + "cached_key_scale"]
            cvs = cache[p + "cached_value_scale"]
            writes = ((ck, k_w), (cv, v_w), (cks, ks_w), (cvs, vs_w))
        else:
            writes = ((ck, k.to(cfg.dtype)), (cv, v.to(cfg.dtype)))
        for buf, new in writes:
            _write_rows(buf, new, dec.index)
        lq = q.shape[1]
        offs = torch.arange(lq, device=q.device)
        qpos = ((dec.index + offs)[None, :] if isinstance(dec.index, int)
                else dec.index[:, None] + offs[None, :])
        if quant:
            # int8 -> model dtype is exact for [-127, 127]; the scales
            # factor out of the head_dim contraction
            return cache_attention(
                q, ck.to(cfg.dtype), cv.to(cfg.dtype), qpos, dec.pad_len,
                cfg.attention_window, cfg.dtype, _kv_scale_rows(cks),
                _kv_scale_rows(cvs))
        return cache_attention(q, ck, cv, qpos, dec.pad_len,
                               cfg.attention_window, cfg.dtype)

    def _decode_rolling(self, q, k, v, dec: Decode, w: int):
        """The rolling cache: slot = position % W keeps the last W
        positions. Attention reads the OLD cache plus the chunk's own k/v,
        and the chunk is written afterwards: a write may overwrite slot
        p - W while an earlier row of the chunk still needs it. Under
        int8 the chunk is quantized before it attends, so its in-chunk
        term sees the same round trip as a later cache read."""
        cfg = self.cfg
        b, lq = q.shape[:2]
        p, cache = self.cache_prefix, dec.cache
        ck, cv = cache[p + "cached_key"], cache[p + "cached_value"]
        quant = cfg.kv_cache_dtype == "int8"
        if quant:
            cks = cache[p + "cached_key_scale"]
            cvs = cache[p + "cached_value_scale"]
            k_old, v_old = ck.to(cfg.dtype), cv.to(cfg.dtype)
            ksc, vsc = _kv_scale_rows(cks), _kv_scale_rows(cvs)
            k_w, ks_w = symmetric_int8(k, -1)
            v_w, vs_w = symmetric_int8(v, -1)
            k_c, v_c = k_w.to(cfg.dtype), v_w.to(cfg.dtype)
        else:
            k_old, v_old = ck, cv
            k_w, v_w = k.to(cfg.dtype), v.to(cfg.dtype)
            k_c, v_c = k_w, v_w
        # the old-cache term [b, hkv, g, lq, W], the in-chunk term [..., lq]
        lc, ls = _grouped_scores(q, k_old), _grouped_scores(q, k_c)
        if quant:
            lc = lc * ksc
            ls = ls * _kv_scale_rows(ks_w)
        dev = q.device
        slots = torch.arange(w, device=dev)
        cols = torch.arange(lq, device=dev)
        idx, pad = dec.index, dec.pad_len
        if isinstance(idx, int):
            # query row r sits at idx + r; each slot holds the largest
            # position <= idx - 1 of its residue (negative: never written)
            qpos = idx + cols
            pos_abs = (idx - 1) - ((idx - 1 - slots) % w)          # [W]
            mc = ((pos_abs[None, :] >= 0)
                  & (pos_abs[None, :] > qpos[:, None] - w))[None]   # [1, lq, W]
            ms = ((cols[None, :] <= cols[:, None])
                  & (cols[None, :] > cols[:, None] - w))[None]      # [1, lq, lq]
            if pad is not None:
                mc = mc & (pos_abs[None, None, :] >= pad[:, None, None])
                ms = ms & (qpos[None, None, :] >= pad[:, None, None])
        else:
            if lq != 1:
                raise ValueError(
                    "rolling_kv_cache vector decode is single-token "
                    f"(got chunk width {lq}); speculative/paged chunks "
                    "need the full or paged cache")
            cur_old = idx[:, None] - 1
            pos_abs = cur_old - ((cur_old - slots[None, :]) % w)   # [b, W]
            mc = ((pos_abs >= 0) & (pos_abs > idx[:, None] - w))[:, None]
            ms = torch.ones((b, 1, 1), dtype=torch.bool, device=dev)
            if pad is not None:
                mc = mc & (pos_abs[:, None, :] >= pad[:, None, None])
                ms = ms & (idx[:, None, None] >= pad[:, None, None])
        lc = torch.where(mc[:, None, None], lc, NEG_FILL)
        ls = torch.where(ms[:, None, None], ls, NEG_FILL)
        probs = torch.softmax(torch.cat([lc, ls], dim=-1), dim=-1)
        pc, ps = probs[..., :w], probs[..., w:]
        if quant:
            pc = pc * vsc
            ps = ps * _kv_scale_rows(vs_w)
        out = _ungroup(_grouped_mix(pc, v_old, cfg.dtype)
                       + _grouped_mix(ps, v_c, cfg.dtype))
        # write the (already quantized) chunk after attending
        writes = [(ck, k_w), (cv, v_w)]
        if quant:
            writes += [(cks, ks_w), (cvs, vs_w)]
        if isinstance(idx, int):
            # only the last W columns survive a wrap; their slots differ
            alive = cols[max(lq - w, 0):]
            at = (idx + alive) % w
            for buf, new in writes:
                buf[:, at] = new[:, alive]
        else:
            rows = torch.arange(b, device=dev)
            at = idx % w
            for buf, new in writes:
                buf[rows, at] = new[:, 0]
        return out

    def _decode_paged(self, q, k, v, dec: Decode):
        """Scatter the chunk to (table[pos // PS], pos % PS), then gather
        each row's pages into a logical [B, MP * PS] view and attend as
        the dense path does. A position one past the table (an idle
        lockstep slot) clamps to the last entry, as the reference's
        gather does; a freed slot's row is all trash page."""
        cfg = self.cfg
        b, lq = q.shape[:2]
        hkv, hd, ps = cfg.n_kv_heads, cfg.head_dim, cfg.kv_page_size
        table = dec.page_table
        mp = table.shape[1]
        idx = dec.index
        if isinstance(idx, int):
            idx = torch.full((b,), idx, dtype=torch.long, device=q.device)
        pos_q = idx[:, None] + torch.arange(lq, device=q.device)[None, :]
        flat = pos_q.reshape(-1)
        rows = torch.arange(b, device=q.device).repeat_interleave(lq)
        pages = table[rows, (flat // ps).clamp(0, mp - 1)]
        offs = flat % ps
        p = self.cache_prefix
        ck, cv = dec.cache[p + "key_pages"], dec.cache[p + "value_pages"]
        ck[pages, offs] = k.to(cfg.dtype).reshape(b * lq, hkv, hd)
        cv[pages, offs] = v.to(cfg.dtype).reshape(b * lq, hkv, hd)
        k_all = ck[table].reshape(b, mp * ps, hkv, hd)
        v_all = cv[table].reshape(b, mp * ps, hkv, hd)
        return cache_attention(q, k_all, v_all, pos_q, dec.pad_len,
                               cfg.attention_window, cfg.dtype)


class SwiGLU(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        dt = cfg.dtype
        self.gate = Dense(cfg.d_model, cfg.d_ff, dt, device)
        self.up = Dense(cfg.d_model, cfg.d_ff, dt, device)
        self.down = Dense(cfg.d_ff, cfg.d_model, dt, device)
        self.tp_in = self.tp_out = _identity   # as Attention's

    def forward(self, x):
        x = self.tp_in(x)
        return self.tp_out(self.down(F.silu(self.gate(x)) * self.up(x)))


class LMHead(nn.Module):
    """Vocab projection: operands in the model dtype, f32 logits. The
    kernel is [d_model, vocab] f32, as the reference's lm_head/kernel."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.dtype = cfg.dtype
        self.kernel = nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, device=device))
        # the full kernel from this rank's vocab shard under tensor
        # parallelism (parallel/shardings.py)
        self.gather = _identity

    def forward(self, x):
        return head_logits(x, self.gather(self.kernel), self.dtype)

    def xent(self, hidden, labels, n_chunks: int):
        """(loss, accuracy) of `hidden` [B, L, d] against `labels`,
        chunked over the sequence (ops/xent.py)."""
        return chunked_lm_xent(hidden, self.gather(self.kernel), labels,
                               n_chunks, compute_dtype=self.dtype)


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
    def __init__(self, cfg: TransformerConfig, device, name: str = "",
                 use_moe: bool = False):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.attn = Attention(cfg, device, f"{name}/attn/")
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.dtype, device)
        if use_moe:
            from kubeflow_tpu_torch.ops.moe import MoEBlock

            self.moe = MoEBlock(cfg, device)
        else:
            self.mlp = SwiGLU(cfg, device)

    @property
    def ffn(self) -> nn.Module:
        """The MLP half: the MoEBlock or the SwiGLU."""
        return self.moe if hasattr(self, "moe") else self.mlp

    def forward(self, x, positions, segment_ids=None, remat=None,
                decode=None):
        """One block (a decode step when `decode` is given); `remat` names the policy that decides what the
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
        if decode is not None:
            x = x + self.attn(self.ln_attn(x), positions, decode=decode)
            return x + self.ffn(self.ln_mlp(x))
        if remat in ("full", "dots"):
            extra = {"context_fn": _dots_contexts} if remat == "dots" else {}
            return checkpoint(self._body, x, positions, segment_ids, None,
                              use_reentrant=False, **extra)
        return self._body(x, positions, segment_ids, remat)

    def _body(self, x, positions, segment_ids, remat):
        norm = _replayed if remat == "slim" else _direct
        mlp = _replayed if remat in ("mlp", "slim") else _direct
        x = x + self.attn(norm(self.ln_attn, x), positions, segment_ids)
        return x + mlp(self.ffn, norm(self.ln_mlp, x))


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
            self.add_module(f"layer_{i}", Block(
                cfg, dev, f"layer_{i}",
                use_moe=bool(cfg.moe_every) and (i + 1) % cfg.moe_every == 0))
        self.ln_f = RMSNorm(cfg.d_model, cfg.dtype, dev)
        self.lm_head = LMHead(cfg, dev)
        self.gather_embedding = _identity   # as LMHead.gather
        # the layers this process runs (a pipeline stage keeps its own,
        # parallel/pipeline.py) and the seq axis' AxisGroup (this rank's
        # tokens are block seq.rank of the sequence)
        self.layer_ids = list(range(cfg.n_layers))
        self.seq = None
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
        return [getattr(self, f"layer_{i}") for i in self.layer_ids]

    def moe_blocks(self):
        """The MoEBlocks of the layers this process runs."""
        return [b.moe for b in self.blocks() if hasattr(b, "moe")]

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def cache_kv_heads(self) -> int:
        """The kv heads this rank's decode cache holds: its k projection's
        (a slice of them under tensor parallelism), or the replicated
        heads its q heads use."""
        attn = self.blocks()[0].attn
        if attn.kv_heads is not None:
            return len(attn.kv_heads)
        return attn.k.weight.shape[0] // self.cfg.head_dim

    def apply(self, params, *args, **kwargs):
        """forward with `params` (a name -> tensor dict, e.g. weights cast
        or dequantized for serving) in place of the module's own; None
        runs on the module's own parameters."""
        if params is None:
            return self(*args, **kwargs)
        return torch.func.functional_call(self, params, args, kwargs)

    def forward(self, tokens, segment_ids=None, decode_index=None,
                return_hidden: bool = False, pad_len=None, page_table=None,
                cache=None):
        """tokens [B, L] -> f32 logits [B, L, V], or the final-norm hidden
        states [B, L, d] with return_hidden (the chunked-loss path).

        Decode: with `decode_index` (an int, or a [B] tensor of per-row
        starts) and `cache` (`runtime/generate.py` init_cache, or
        `runtime/kvcache.py` init_paged_cache with a [B, MP] `page_table`),
        token row r of the chunk sits at position decode_index + r; its
        k/v are written into `cache` in place before it attends.
        `pad_len` [B] masks each row's left padding."""
        cfg = self.cfg
        if decode_index is not None and cfg.pipeline_stages > 1:
            raise ValueError("decode is not supported under pipeline "
                             "parallelism yet")
        x = self.embed(tokens)
        if decode_index is not None:
            if cache is None:
                raise ValueError("decode needs cache= (init_cache or "
                                 "init_paged_cache)")
            idx = decode_index
            if isinstance(idx, torch.Tensor):
                idx = (int(idx) if idx.ndim == 0
                       else idx.to(device=tokens.device, dtype=torch.long))
            offs = torch.arange(tokens.shape[1], device=tokens.device)
            positions = ((idx + offs).expand(tokens.shape)
                         if isinstance(idx, int) else idx[:, None] + offs)
            if page_table is not None:
                page_table = page_table.to(device=tokens.device,
                                           dtype=torch.long)
            dec = Decode(idx, pad_len, page_table, cache)
            for blk in self.blocks():
                x = blk(x, positions, decode=dec)
            return self.lm_head(self.ln_f(x))
        if cfg.pipeline_stages > 1:
            self.check_pipeline(tokens.shape[0], segment_ids)
        x = self.run_blocks(x, self.positions(tokens), segment_ids)
        return self.head(x, return_hidden)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(
            tokens, self.gather_embedding(self.embedding).to(self.cfg.dtype))

    def positions(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, L] positions of `tokens`: this rank's block of the sequence
        under a seq group."""
        l = tokens.shape[1]
        start = self.seq.rank * l if self.seq is not None else 0
        return torch.arange(start, start + l, device=tokens.device
                            ).expand(tokens.shape)

    def run_blocks(self, x, positions, segment_ids=None):
        """The blocks this process runs, under the remat policy."""
        cfg = self.cfg
        policy, k_mix = (_split_policy(cfg.remat_policy) if cfg.remat
                         else (None, None))
        for i, blk in enumerate(self.blocks()):
            # policy@K: the first K blocks remat, the rest save everything
            remat = policy if k_mix is None or i < k_mix else None
            x = blk(x, positions, segment_ids, remat)
        return x

    def head(self, x, return_hidden: bool = False):
        x = self.ln_f(x)
        return x if return_hidden else self.lm_head(x)

    def check_pipeline(self, batch: int, segment_ids=None) -> int:
        """The reference's refusals for pipeline stages, in its order;
        returns the microbatch count (1 for a batch smaller than
        pp_microbatches, as the reference's shape-only paths)."""
        cfg = self.cfg
        if cfg.n_layers % cfg.pipeline_stages:
            raise ValueError(
                f"n_layers={cfg.n_layers} not divisible by "
                f"pipeline_stages={cfg.pipeline_stages}")
        if (cfg.moe_every or cfg.attention_impl in ("ring", "ulysses")
                or segment_ids is not None):
            raise ValueError("pipeline stages support dense blocks with "
                             "local attention only (no moe/ring/ulysses/"
                             "segments yet)")
        n_mb = cfg.pp_microbatches
        if n_mb <= 0 or batch % n_mb:
            if batch >= n_mb:
                raise ValueError(
                    f"batch {batch} not divisible by n_microbatches {n_mb}")
            n_mb = 1
        if cfg.remat and _split_policy(cfg.remat_policy)[1] is not None:
            raise ValueError(
                f"mixed remat policy {cfg.remat_policy!r} is not "
                "supported under pipeline parallelism (stages would "
                "carry unequal activation memory)")
        return n_mb

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
    "moe-test": dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=4, head_dim=16, d_ff=128, moe_every=2,
                     n_experts=4, expert_top_k=2),
    "gpt-moe-8e": dict(d_model=1024, n_layers=24, n_heads=16, n_kv_heads=16,
                       head_dim=64, d_ff=4096, moe_every=2, n_experts=8,
                       expert_top_k=2),
}
for _name, _base in CONFIGS.items():
    _registered(_name, _base)
