"""Autoregressive generation with the KV cache (port of
kubeflow_tpu/runtime/generate.py).

Prefill writes the prompt into every layer's cache in GEMM-shaped
position chunks (PREFILL_CHUNK wide), then each sampled token is fed
back through the model's decode path, [B, 1] tokens against the cache.
`model` is a TransformerLM or a serving/quant.py QuantizedModel; both
take their weights as an argument (`model.apply(params, ...)`), never
from a closure, and `params` None means the module's own.

Sampling: greedy (temperature 0) takes the argmax; otherwise logits are
divided by the temperature, top-k keeps every logit at or above the kth
largest (ties included), and a token is drawn from a seeded
`torch.Generator` on the model's device. Sampled tokens cannot match
the reference's (another RNG); greedy tokens do.
"""

from __future__ import annotations

import os

import torch

from kubeflow_tpu_torch.models.transformer import decode_cache_shapes

NEG_FILL = -1e30

# Prefill chunk width: each apply feeds this many positions, so every
# projection is a GEMM rather than a per-position GEMV.
PREFILL_CHUNK = 128


def init_cache(model, batch: int) -> dict[str, torch.Tensor]:
    """Zero dense decode caches for `batch` rows on the model's device,
    shaped from its config alone (`decode_cache_shapes`)."""
    return {name: torch.zeros(shape, dtype=dtype, device=model.device)
            for name, (shape, dtype)
            in decode_cache_shapes(model.cfg, batch).items()}


def check_decode_geometry(model, prompt_len: int, max_new_tokens: int) -> None:
    """Refuse a decode that would run past max_seq_len (the reference's
    scalar write would shift and its per-row write drop: garbage)."""
    limit = model.cfg.max_seq_len
    if prompt_len + max_new_tokens > limit:
        raise ValueError(
            f"prompt_len + max_new_tokens = {prompt_len + max_new_tokens} "
            f"exceeds the model's max_seq_len {limit}")


def prefill_scan(model, params, cache, prompts: torch.Tensor, pad_len,
                 chunk: int = 0):
    """Run a [B, P] prompt through the cache in position chunks; returns
    (cache, last_logits [B, V] f32). Full chunks of width `chunk` (0:
    the KFTPU_PREFILL_CHUNK env, else PREFILL_CHUNK) and then one
    remainder chunk, so every prompt length prefills in GEMMs; an empty
    prompt leaves the cache alone and gives zero logits. The one prefill
    of generate() and the slot decoder."""
    b, lp = prompts.shape
    width = chunk or int(os.environ.get("KFTPU_PREFILL_CHUNK", PREFILL_CHUNK))
    c = min(max(width, 1), lp)
    logits = torch.zeros((b, model.cfg.vocab_size), dtype=torch.float32,
                         device=prompts.device)
    if not lp:
        return cache, logits
    for start in range(0, lp, c):
        out = model.apply(params, prompts[:, start:start + c],
                          decode_index=start, pad_len=pad_len, cache=cache)
        logits = out[:, -1]
    return cache, logits


def prefill_per_token(model, params, cache, prompts: torch.Tensor, pad_len):
    """One position per apply: the oracle for prefill_scan."""
    b, lp = prompts.shape
    logits = torch.zeros((b, model.cfg.vocab_size), dtype=torch.float32,
                         device=prompts.device)
    for i in range(lp):
        logits = model.apply(params, prompts[:, i:i + 1], decode_index=i,
                             pad_len=pad_len, cache=cache)[:, 0]
    return cache, logits


def _sample(logits: torch.Tensor, temperature: float, top_k: int,
            generator: torch.Generator | None) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, NEG_FILL, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


@torch.no_grad()
def generate(model, params, prompt: torch.Tensor, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: int = 0, seed: int = 0,
             pad_len: torch.Tensor | None = None) -> torch.Tensor:
    """prompt [B, Lp] int (all rows one length; a ragged batch is
    left-padded, with `pad_len` [B] the pad count of each row) ->
    [B, Lp + max_new_tokens], the prompt and then the new tokens."""
    b, lp = prompt.shape
    check_decode_geometry(model, lp, max_new_tokens)
    cache = init_cache(model, b)
    cache, logits = prefill_scan(model, params, cache, prompt, pad_len)
    gen = generator(prompt.device, seed)
    toks = []
    for i in range(max_new_tokens):
        tok = _sample(logits, temperature, top_k, gen)
        toks.append(tok)
        if i + 1 < max_new_tokens:    # the last token's logits go unused
            logits = model.apply(params, tok[:, None], decode_index=lp + i,
                                 pad_len=pad_len, cache=cache)[:, 0]
    new = torch.stack(toks, dim=1) if toks else prompt[:, :0]
    return torch.cat([prompt, new.to(prompt.dtype)], dim=1)
