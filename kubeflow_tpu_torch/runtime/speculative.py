"""Greedy speculative decoding (port of kubeflow_tpu/runtime/speculative.py):
a small draft model proposes k tokens, the target verifies them in one
multi-position forward and accepts the longest prefix that matches its
own argmaxes, plus one token of its own. The output is exactly the
target's greedy decode; the draft only moves the acceptance rate.

No rollback: a rejected proposal leaves stale cache entries past the
accept point, but the next chunk writes exactly that range before any
query attends to it (write, then attend, in one apply), and the causal
mask hides positions past the chunk. This holds for the full and paged
caches, never for the rolling one, which is refused.

`lockstep_propose` / `lockstep_verify` are the same round over S slots
at per-slot positions, what SlotDecoder's speculative loop drives.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.runtime.generate import init_cache, prefill_scan


def _draft_propose(model, params, cache, cur: torch.Tensor, n: int, *,
                   k: int, pad_len=None) -> torch.Tensor:
    """k greedy draft steps from token `cur` [B, 1] at position `n`,
    writing `cache` in place; returns the proposals [B, k]."""
    toks = []
    tok = cur
    for i in range(k):
        logits = model.apply(params, tok, decode_index=n + i,
                             pad_len=pad_len, cache=cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1)


def _verify_chunk(model, params, cache, chunk: torch.Tensor, n: int,
                  pad_len=None) -> torch.Tensor:
    """Target forward over the [B, C] chunk at positions n..n+C-1;
    returns the logits [B, C, V]."""
    return model.apply(params, chunk, decode_index=n, pad_len=pad_len,
                       cache=cache)


def greedy_accept(drafted, targets, k: int) -> int:
    """Longest prefix of the k proposals the target's greedy argmaxes
    agree with: the one acceptance rule of the batch-1 loop and the
    lockstep slot decoder."""
    a = 0
    while a < k and drafted[a] == targets[a]:
        a += 1
    return a


def lockstep_propose(model, params, cache, emitted: torch.Tensor,
                     start: torch.Tensor, elen: torch.Tensor, *, k: int,
                     pad_len=None) -> torch.Tensor:
    """Resync and propose for S slots in lockstep. emitted [S, k+1]: the
    tokens each slot emitted last round, right-padded; start [S]: the
    position of each row's first; elen [S]: valid lengths. One chunk
    apply re-feeds them (the first proposal comes from the last valid
    row's logits), then k-1 single steps; returns proposals [S, k].
    Pad columns write at future positions, which a later chunk
    rewrites before any query reaches them."""
    logits = model.apply(params, emitted, decode_index=start,
                         pad_len=pad_len, cache=cache)
    last = torch.gather(
        logits, 1, (elen - 1)[:, None, None].expand(-1, 1, logits.shape[-1])
    )[:, 0]
    tok = torch.argmax(last, dim=-1)                      # d_1
    props = [tok]
    idx = start + elen
    for _ in range(k - 1):
        lg = model.apply(params, tok[:, None], decode_index=idx,
                         pad_len=pad_len, cache=cache)
        tok = torch.argmax(lg[:, 0], dim=-1)
        props.append(tok)
        idx = idx + 1
    return torch.stack(props, dim=1)


def lockstep_verify(model, params, cache, chunk: torch.Tensor,
                    n: torch.Tensor, pad_len=None, page_table=None
                    ) -> torch.Tensor:
    """Target forward over [S, C] chunks at per-slot positions n[s]
    (dense or paged cache); returns the greedy targets [S, C]."""
    logits = model.apply(params, chunk, decode_index=n, pad_len=pad_len,
                         page_table=page_table, cache=cache)
    return torch.argmax(logits, dim=-1)


def check_speculative_models(target, draft) -> None:
    """Speculation needs the full (or paged) cache on both models."""
    for name, m in (("target", target), ("draft", draft)):
        if getattr(m.cfg, "rolling_kv_cache", False):
            # a rejection rewinds the decode index: a rolling slot would
            # hold a rejected newer position that the window mask dates
            # as the older one of the same residue
            raise ValueError(
                f"speculative decoding requires the full KV cache; "
                f"{name} has rolling_kv_cache=True")


@torch.no_grad()
def speculative_generate(target, target_params, draft, draft_params,
                         prompt: torch.Tensor, *, max_new_tokens: int,
                         k: int = 4, pad_len=None
                         ) -> tuple[torch.Tensor, dict]:
    """Greedy decode of `target` accelerated by `draft`. prompt [1, P]
    (batch 1: accept lengths are data-dependent, so rows cannot share a
    round); params None means a model's own. Returns (tokens
    [1, P + max_new_tokens], {"rounds", "drafted", "accepted",
    "tokens"})."""
    if prompt.shape[0] != 1:
        raise ValueError("speculative_generate is batch-1 "
                         f"(got batch {prompt.shape[0]}); batch via the "
                         "serving layer")
    check_speculative_models(target, draft)
    p_len = prompt.shape[1]
    for name, m in (("target", target), ("draft", draft)):
        need = p_len + max_new_tokens + k
        if m.cfg.max_seq_len < need:
            raise ValueError(
                f"{name} max_seq_len {m.cfg.max_seq_len} < prompt + "
                f"max_new_tokens + k = {need} (the verify chunk may "
                "write up to k positions past the last emitted token)")
    t_cache, t_logits = prefill_scan(target, target_params,
                                     init_cache(target, 1), prompt, pad_len)
    d_cache, _ = prefill_scan(draft, draft_params, init_cache(draft, 1),
                              prompt, pad_len)
    dev = prompt.device

    def col(tok: int) -> torch.Tensor:
        return torch.full((1, 1), tok, dtype=torch.long, device=dev)

    # the first new token comes from the target's prefill
    cur = int(torch.argmax(t_logits, dim=-1)[0])
    out = [cur]
    n = p_len                  # `cur` sits at position n
    rounds = accepted_total = 0
    while len(out) < max_new_tokens:
        props = _draft_propose(draft, draft_params, d_cache, col(cur), n,
                               k=k, pad_len=pad_len)
        # verify [cur, d_1 .. d_k] at n .. n+k: all k proposals are
        # judged, so a full accept emits k + 1 tokens
        chunk = torch.cat([col(cur), props], dim=1)
        logits = _verify_chunk(target, target_params, t_cache, chunk, n,
                               pad_len=pad_len)
        y = torch.argmax(logits, dim=-1)[0].tolist()      # [k+1]
        d = props[0].tolist()                             # [k]
        a = greedy_accept(d, y, k)
        emitted = d[:a] + [y[a]]
        if a == k:
            # full accept: the draft never consumed d_k, so its cache
            # lacks position n + k; one tick heals it (proposal unused)
            _draft_propose(draft, draft_params, d_cache, col(d[k - 1]),
                           n + k, k=1, pad_len=pad_len)
        out.extend(emitted)
        cur = emitted[-1]
        n += a + 1
        rounds += 1
        accepted_total += a
    out = out[:max_new_tokens]
    tokens = torch.cat([prompt, torch.tensor([out], dtype=prompt.dtype,
                                             device=dev)], dim=1)
    return tokens, {"rounds": rounds, "drafted": rounds * k,
                    "accepted": accepted_total, "tokens": len(out)}
