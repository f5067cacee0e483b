"""LM serving benchmark on one GPU: the port's twin of
`tools/serve_bench.py run_mode`.

    python -m kubeflow_tpu_torch.serve_bench [--modes continuous]
        [--model gpt-350m] [--requests 32] [--concurrency 16] [--slots 16]
        [--prompt-len 512] [--max-new-tokens 64] [--param-dtype int8]
        [--kv-pages 0 --kv-page-size 0] [--kv-cache-dtype int8]
        [--attention-window 256 --rolling-kv-cache]
        [--self-draft]
        [--device cpu]

The defaults are the serving point `tools/serve_best.json` pins for the
reference (continuous batching, 16 slots, concurrency 16, 32 requests,
gpt-350m with vocab 32000, int8 weights, 64 new tokens) with
serve_bench's default prompt_len 512. Random weights from `--seed`.
Prompts come from random.Random(0), each of length 4..prompt_len. After
a warm-up (one predict of 1, 2, 4, ... instances up to the
concurrency), a closed loop keeps `--concurrency` single-instance
predicts in flight until `--requests` are done. Prints one JSON line
per mode with run_mode's fields, plus the peak device memory, the
decode cache's bytes and the card's name and power limit. Runs on the
card unless `--device cpu` is given (then no device figure is printed).

Speculative arm: `--self-draft` serves with the target's own weights as
the draft (k = SELF_DRAFT_K, the reference arm's), a draft that agrees
with every greedy pick: the tokens-per-forward ceiling. It adds the
acceptance counters to the line.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import threading
import time
from typing import Callable

# tokens the self-draft proposes per round: tools/serve_bench.py's draft_k
SELF_DRAFT_K = 4


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="gpt-350m")
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--prompt-len", type=int, default=512)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--concurrency", type=int, default=16)
    p.add_argument("--slots", type=int, default=16)
    p.add_argument("--window-ms", type=float, default=5.0,
                   help="micro-batching window of the micro mode")
    p.add_argument("--param-dtype", default="int8",
                   choices=["bfloat16", "float32", "int8", "int4", ""])
    p.add_argument("--kv-pages", type=int, default=0)
    p.add_argument("--kv-page-size", type=int, default=0)
    p.add_argument("--kv-cache-dtype", default="", choices=["", "auto", "int8"])
    p.add_argument("--attention-window", type=int, default=0,
                   help="sliding-window width of the served model (0: full "
                        "causal)")
    p.add_argument("--rolling-kv-cache", action="store_true",
                   help="bound the KV cache to the window (O(window) memory "
                        "and per-step cache stream)")
    p.add_argument("--self-draft", action="store_true",
                   help="draft = the target's own weights (the acceptance "
                        "ceiling)")
    p.add_argument("--modes", default="continuous")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def bench_prompts(n: int, prompt_len: int, vocab: int) -> list[list[int]]:
    """run_mode's prompts: random.Random(0), lengths 4..prompt_len-1."""
    rng = random.Random(0)
    return [[rng.randrange(1, vocab) for _ in range(rng.randrange(4, prompt_len))]
            for _ in range(n)]


def closed_loop(send: Callable[[list[int]], list[int]],
                prompts: list[list[int]], concurrency: int
                ) -> tuple[list[float], list[list[int]], float]:
    """send(prompt) for each prompt, `concurrency` in flight; returns the
    sorted latencies (s), the outputs in prompt order and the wall time.
    A failed send is re-raised after every thread has ended."""
    latencies: list[float] = []
    outs: list = [None] * len(prompts)
    errors: list[BaseException] = []
    lock = threading.Lock()
    sem = threading.Semaphore(concurrency)

    def one(i: int) -> None:
        try:
            t0 = time.perf_counter()
            out = send(prompts[i])
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)
                outs[i] = out
        except BaseException as e:  # noqa: BLE001 - re-raised below
            with lock:
                errors.append(e)
        finally:
            sem.release()

    threads = []
    t_start = time.perf_counter()
    for i in range(len(prompts)):
        sem.acquire()
        th = threading.Thread(target=one, args=(i,))
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    wall = time.perf_counter() - t_start
    if errors:
        raise errors[0]
    return sorted(latencies), outs, wall


def summary(mode: str, args: argparse.Namespace, latencies: list[float],
            wall: float) -> dict:
    """run_mode's fields."""

    def pct(q: float) -> float:
        return round(latencies[min(len(latencies) - 1,
                                   int(q * len(latencies)))] * 1e3, 1)

    return {
        "mode": mode,
        "requests": args.requests,
        "concurrency": args.concurrency,
        "slots": args.slots,
        "tokens_per_sec": round(args.requests * args.max_new_tokens / wall, 1),
        "requests_per_sec": round(args.requests / wall, 2),
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        "p99_ms": pct(0.99),
        "wall_s": round(wall, 2),
        "model": args.model,
        "max_new_tokens": args.max_new_tokens,
        "param_dtype": args.param_dtype or "f32",
        **({"kv_cache_dtype": args.kv_cache_dtype}
           if args.kv_cache_dtype else {}),
        **({"attention_window": args.attention_window,
            "rolling_kv_cache": args.rolling_kv_cache}
           if args.attention_window else {}),
        **({"draft_model": args.model, "draft_k": SELF_DRAFT_K}
           if args.self_draft else {}),
    }


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def served_model(mode: str, args: argparse.Namespace):
    from kubeflow_tpu_torch.serving.server import serve_lm_generator

    spec = {}
    if args.self_draft:
        from kubeflow_tpu_torch.models.registry import get_model

        # the target's own weights: the same registry draw from the seed
        spec = {"draft_model": args.model, "draft_k": SELF_DRAFT_K,
                "draft_state_dict": get_model(
                    args.model, device=args.device, seed=args.seed,
                    vocab_size=args.vocab_size).state_dict()}
    return serve_lm_generator(
        "bench", args.model, prompt_len=args.prompt_len,
        max_new_tokens=args.max_new_tokens,
        continuous_batching=(mode == "continuous"),
        decode_slots=args.slots, seed=args.seed, device=args.device,
        **({"kv_pages": args.kv_pages, "kv_page_size": args.kv_page_size}
           if args.kv_pages and mode == "continuous" else {}),
        batch_window_ms=(args.window_ms if mode == "micro" else 0.0),
        param_dtype=args.param_dtype or None,
        vocab_size=args.vocab_size,
        **({"kv_cache_dtype": args.kv_cache_dtype}
           if args.kv_cache_dtype else {}),
        **({"attention_window": args.attention_window}
           if args.attention_window else {}),
        **({"rolling_kv_cache": True} if args.rolling_kv_cache else {}),
        **spec)


def warm_up(predict: Callable[[list], list], prompts: list[list[int]],
            concurrency: int) -> None:
    """One predict of each power-of-two instance count up to the
    concurrency, so no first-call cost lands in the timed loop."""
    k = 1
    while k <= max(1, concurrency):
        predict([{"tokens": prompts[i % len(prompts)]} for i in range(k)])
        k *= 2


def run_mode(mode: str, args: argparse.Namespace) -> dict:
    import torch

    on_card = args.device is None or torch.device(args.device).type == "cuda"
    served = served_model(mode, args)
    try:
        prompts = bench_prompts(args.requests, args.prompt_len,
                                args.vocab_size)
        warm_up(served.predict, prompts, args.concurrency)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        latencies, outs, wall = closed_loop(
            lambda p: served.predict([{"tokens": p}])[0], prompts,
            args.concurrency)
        for out in outs:
            if len(out) != args.max_new_tokens or not all(
                    0 <= t < args.vocab_size for t in out):
                raise RuntimeError(f"bad response {out}")
        result = summary(mode, args, latencies, wall)
        dec = served.decoder()
        if dec is not None:
            stats = dec.stats()
            result["cache_bytes"] = stats["cache_bytes"]
            if stats["speculative"]:
                result.update(spec_stats(stats))
        if on_card:
            result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            result["device"] = torch.cuda.get_device_name(0)
            result["card"] = card()
        else:
            result["device"] = "cpu"
        return result
    finally:
        served.close()


SPEC_KEYS = ("spec_rounds", "spec_tokens_emitted", "spec_tokens_accepted",
             "spec_drafted")


def spec_stats(stats: dict) -> dict:
    """The lockstep decoder's speculative counters, with the acceptance
    rate (accepted / drafted) and tokens per target forward (emitted /
    slot-rounds)."""
    out = {k: stats[k] for k in SPEC_KEYS}
    out["acceptance_rate"] = (stats["spec_tokens_accepted"]
                              / max(stats["spec_drafted"], 1))
    out["tokens_per_round"] = (stats["spec_tokens_emitted"]
                               / max(stats["spec_rounds"], 1))
    return out


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    for mode in args.modes.split(","):
        print(json.dumps(run_mode(mode.strip(), args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
