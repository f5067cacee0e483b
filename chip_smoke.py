#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`kubeflow_tpu_torch`) on one GPU.

    python3 chip_smoke.py

1. Prints the card (`nvidia-smi` name and power limit) and builds the
   CUDA kernels from `kubeflow_tpu_torch/ops/csrc`, timing the build and
   printing each kernel's registers and spills at head_dim 64 and 128.
2. Kernel phase, at llama-1b attention shapes (q [8, 2048, 32, 64], k/v
   8 heads, bf16, causal): runs each kernel (flash fwd, bwd dq, bwd dk/dv;
   all three warp-specialised sm_90a kernels: a TMA producer thread
   feeding an mbarrier ring, two consumer warpgroups running wgmma; dq
   keeps its 128-row Q and dO tiles resident and streams 128-key K/V
   tiles, S and dP as SS wgmma, dQ += dS.K as RS wgmma) and holds it
   against its plain PyTorch version on the same inputs, the plain
   version blocked at that kernel's own tiles (`KERNEL_TILES`), then
   again with a sliding window and with packed-sequence segment ids. The
   limit is per row (`kubeflow_tpu_torch/ops/kernel_check.py`): every
   row's L2 error within 1e-2 of that row's L2 norm (2e-2 for dq, whose
   rows cancel), lse within 1e-3.
   Times each kernel, its plain version and the PyTorch library call for
   the same function (scaled_dot_product_attention, forward / backward):
   CUDA events around a run of back-to-back launches, per launch, the
   median of five such runs, so the host's launch overhead overlaps the
   device's work. Works out each kernel's bound.
3. LM-head check: the card's bf16 head GEMM (`ops/xent.py`) against its
   plain f32 formula on the same card tensors, at one main-path chunk:
   logits, dx and dkernel, each within 1e-2 per row.
4. Small reference check: a 2-layer llama-1b-width model gives the same
   logits through the flash kernel as through reference attention, each
   token's logits within 2e-2 per row (two layers of bf16 activations).
5. Remat check: a 2-layer llama-1b-width bf16 model, one batch [8, 2048],
   8 xent chunks. Under each remat policy (full, dots, mlp, slim,
   slim@1) the loss and every parameter gradient are held against no
   remat, per row within 1e-2 (the largest difference is printed; it
   should be 0), and the flash forward must launch twice per layer under
   full, which replays it, and once under the others.
6. Main paths, each through the port launcher for 5 steps at llama-1b,
   seq 2048, batch 8, 8 xent chunks, attention_impl auto; each must
   launch every kernel 16 times a step (one per layer) with a finite
   loss: (a) the first slices' adamw with no remat; (b) the operating
   point `tools/lm_best.json` pins for the reference: adafactor, slim
   remat, with `bench.py run_lm`'s lr 3e-4, warmup 5 and weight_decay
   1e-4. Under slim, 16 forward launches a step are the proof that no
   flash forward replays.
7. Gradient accumulation: the pinned config at 4 layers with
   grad_accum_steps 2, 2 steps: every kernel launches 2 x 4 times a
   step, and the loss is finite.
8. Profile: the pinned config, then the adamw one: two warm-up steps,
   then three under torch.profiler; prints the device time by kind of
   kernel, the device's busy share of the step and the peak device
   memory, then the optimizer update's own kernel time (three updates
   profiled by themselves), so the breakdowns and the main paths'
   numbers come from one run.
9. Serving, (a) correctness: gpt-350m width, 4 layers, f32, TF32 off,
   8 ragged prompts (a shared-prefix pair among them): the slot
   decoder's greedy tokens, dense and paged (page size 16), equal
   generate()'s; chunked prefill equals the per-token oracle, logits
   within 1e-4 per row; the page allocator checks clean and every page
   is free for admission at the end; an int8 KV-cache run agrees with
   the f32 run on >= 75% of generated tokens and int8 weights give
   prompt logits that correlate with f32's above 0.99 (the reference's
   bars, tests/test_quant.py); the int8-weight run's share of equal
   generated tokens is printed: one flipped token changes the rest of
   its row, and on a random model of this width the reference's own
   share is as low (tests/test_torch_quant.py). At bf16: chunked prefill
   against the oracle within 2e-2 per row; the bf16-vs-f32 logits row
   error and the share of identical tokens are printed, not held.
10. Serving, (b) the pinned point (`tools/serve_best.json` with
   prompt_len 512): gpt-350m at full depth, bf16, int8 weights, the
   continuous decoder with 16 slots, vocab 32000, random weights from
   seed 0, behind the port's ModelServer on 127.0.0.1: a warm-up, then
   32 requests at concurrency 16 over HTTP; every response must hold 64
   ids in range. Prints tokens/s, requests/s, p50/p95/p99, peak memory
   and the cache's bytes; then 16 ticks of the same decoder with every
   slot busy, timed on the host clock, and 8 more under torch.profiler:
   device time per tick by kind (projection GEMMs, attention bmm,
   sampling, the rest: elementwise, casts and dequantization) against
   the host time per tick, and 16 ticks with the weights dequantized
   once up front (what dequantizing at every tick costs). The dense
   cache must hold 905,969,664 bytes.
11. Entry (run after phase 4): `kubeflow_tpu_torch.entry.entry()` on
   the card (gpt-125m widths, 4 layers, vocab 8192, zero params, tokens
   ones [2, 256], bf16): logits [2, 256, 8192], finite, and 4 flash
   forward launches (one per layer); the flash forward against its
   plain version at that shape ([2, 256, 12, 64], 12 kv heads) per
   row, timed with its plain version and SDPA; then random weights
   (seed 0) at the same config, flash against reference attention,
   within 2e-2 per row.
12. Rolling cache: (a) gpt-350m width, 4 layers, f32, window 16,
   prompts of up to 24 tokens and 24 new (the cache wraps twice): the
   rolling cache's greedy tokens equal the full cache's under the same
   window, for generate() and the slot decoder, dense and int8 cache,
   and its tensors are W-sized; (b) phase 10's point with window 256
   and the rolling cache (prompts up to 511 tokens wrap it at
   prefill): the cache must hold exactly 402,653,184 bytes; the same
   figures and tick profile as phase 10.
13. Speculative decoding: (a) 4 layers, f32: speculative_generate and
   the lockstep slot decoder, dense and paged target, equal greedy
   generate(), with the target's own weights as the draft (accepted ==
   drafted) and with an independent draft; (b) phase 10's point with
   a gpt-125m draft (int8, random from seed 1) and k 4, 16 requests:
   acceptance rate, rounds, tokens/s, p50/p95, peak memory; in bf16
   the share of tokens equal to phase 10's plain greedy is printed,
   not held, beside a witness of why rows differ: for each row, at its
   first differing token, the bf16 target's top-1 minus top-2 logit
   margin on that row's prefix, against the margins of the steps
   before it, and whether the two runs' tokens are that forward's top
   two; (c) the same point computed in f32 (TF32 off), 16 requests
   through the speculative server and a plain one: tokens equal token
   for token (16 busy slots, prompts of up to 511 tokens left-padded
   to 512, int8 target and draft).
14. Router: two ModelServer replicas on the card (gpt-350m width, 4
   layers, f32, continuous batching, paged cache) behind the port's
   RouterFrontend over HttpTransport, 16 concurrent predicts: both
   replicas serve, every response equals a direct replica call, and
   router_queue_depth returns to 0.
15. Resume (run after phase 8): the training runtime at the pinned
   point through `python -m kubeflow_tpu_torch.runtime.launcher` as a
   subprocess, under an injected TRACEPARENT with KFTPU_TRACE_FILE set
   and CUBLAS_WORKSPACE_CONFIG=:4096:8. Packed KFR1 shards from numpy
   draws (documents of 64-3000 tokens packed at seq 2048 with
   `pack_documents`, 8 batches over two shards, and an eval shard of 2
   batches) read by the native loader (`RecordDataset(native=True)`,
   g++-built) through the Prefetcher, so segment ids reach the flash
   kernels; shuffle_buffer 16, checkpoint_every 2, keep 2, eval every 3
   steps over 2 batches, a profiler window at step 2. Run A is SIGTERMed
   after its "step 3" line: exit 75, a strictly valid summary with
   "preempted", the preempted step on disk and in manifest.json, the
   profile naming the three flash kernels. Run B resumes it to step 6:
   start_step that step, exit 0, a finite eval with smoke 0. Run C
   trains 6 steps straight in a fresh directory. B's final parameters
   are held to C's per row within 1e-2, the final losses within 1e-3
   relative (the largest difference is printed); every run launches
   each kernel 16 times a step and the forward 16 more per eval batch
   (read from each launcher's log line); each trace dump is one tree
   (worker under the injected parent, train.fit under worker,
   train.step and train.checkpoint inside). Prints the checkpoint's
   bytes, the seconds each save blocks the loop and writes in the
   background, the restore's seconds, the step time on shards against
   phase 6's synthetic one, and the seconds a restart spends skipping
   10,000 consumed batches before its first step (token_batches over the
   looped shards, and the record reader alone).
16. Serve from checkpoint: `serve_lm_generator(checkpoint_dir=` run B's
   `)` on llama-1b, continuous batching, 4 slots, 4 greedy requests of
   32 new tokens, against generate() on the params `restore_params`
   reads: in f32 (TF32 off) the tokens are equal; in bf16 the share of
   equal tokens is printed and a row may differ only at a near tie: the
   two runs' tokens the top two of that forward, and its top-1 minus
   top-2 margin under 0.25x the median margin of the agreeing steps.
   A draft checkpoint directory with no step fails registration. The
   checkpoints are removed at the end.
Each phase prints its wall seconds.

Any failure exits non-zero. The lines before the last hold the
`{"kernels": [...]}` record (`launches`: the pinned main path's count,
`launches_by_path`: each path's: the training paths, entry, `resume`
(run B: 16 a step of each kernel, 16 more forwards per eval batch), and
the serving, rolling, speculative, router and checkpoint-serving paths,
which must run none of them; the flash forward's row also holds its
figures at the entry shape) and the card; the last line is
`{"ok": true, "device": {...}}`. Needs one CUDA GPU, `nvcc`, `g++` and
no network.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path

# llama-1b attention at the training operating point
B, L, H, HKV, D = 8, 2048, 32, 8, 64
STEPS = 5
LAYERS = 16
REF_ROW_TOL = 2e-2         # 2-layer logits, flash vs reference attention
PEAK_BF16 = 989e12         # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s
SRC = "kubeflow_tpu/ops/flash_attention.py"
# the main path: llama-1b at the operating point tools/lm_best.json pins
# for the reference (adafactor, slim remat, 8 xent chunks), with bench.py
# run_lm's lr 3e-4, warmup 5 and weight_decay 1e-4 (adafactor adds the
# decay unscaled by the learning rate: 0.1 would shrink the weights 10%
# a step)
MAIN_PATH = {
    "model": "llama-1b", "task": "lm",
    "model_kwargs": {"attention_impl": "auto"},
    "global_batch": B, "seq_len": L, "vocab_size": 32000,
    "optimizer": "adafactor", "learning_rate": 3e-4, "weight_decay": 1e-4,
    "warmup_steps": 5, "total_steps": STEPS, "remat": True,
    "remat_policy": "slim", "xent_chunks": 8, "seed": 0, "log_every": 1,
}
# the first slices' main path, kept beside it: adamw, no remat
ADAMW_PATH = {
    **MAIN_PATH, "optimizer": "adamw", "weight_decay": 0.1,
    "warmup_steps": 2, "remat": False,
}
REMAT_POLICIES = ("full", "dots", "mlp", "slim", "slim@1")
ACCUM_LAYERS, ACCUM_STEPS = 4, 2
# serving: the point tools/serve_best.json pins for the reference, with
# tools/serve_bench.py's default prompt_len 512
SERVE = {"model": "gpt-350m", "vocab": 32000, "prompt_len": 512,
         "max_new": 64, "slots": 16, "concurrency": 16, "requests": 32,
         "param_dtype": "int8"}
CHECK_LAYERS, CHECK_P, CHECK_N, CHECK_PAGE = 4, 64, 16, 16
# the pinned point's dense cache, and the rolling one at window 256:
# layers x (k, v) x slots x positions x kv heads x head_dim x bf16 bytes
DENSE_CACHE_BYTES = 24 * 2 * 16 * 576 * 16 * 64 * 2       # 905,969,664
ROLLING_WINDOW = 256
ROLLING_CACHE_BYTES = 24 * 2 * 16 * ROLLING_WINDOW * 16 * 64 * 2  # 402,653,184
ROLL_W, ROLL_P, ROLL_N = 16, 24, 24   # the rolling check wraps W twice
SPEC_K, SPEC_REQUESTS = 4, 16
SPEC_DRAFT = "gpt-125m"
ROUTER_P, ROUTER_N, ROUTER_REQUESTS = 64, 16, 16
PREFILL_ROW_TOL = 1e-4     # f32 chunked prefill vs the per-token oracle
QUANT_AGREE = 0.75         # int8 cache vs f32, generated tokens
QUANT_CORR = 0.99          # int8-weight vs f32 logits, same tokens


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check_rows(name: str, got, want, tol: float) -> dict:
    """kernel_check.errors of got against want; fails past tol per row."""
    from kubeflow_tpu_torch.ops import kernel_check

    e = kernel_check.errors(got, want)
    if not e["max_row_err"] <= tol:
        fail(f"{name}: max row err {e['max_row_err']:.4g} (limit {tol}), "
             f"max abs err {e['max_abs_err']:.4g}")
    return e


def kernel_phase(fa, ptxas: dict) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import kernel_check

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)

    q, dout = randn(B, L, H, D), randn(B, L, H, D)
    k, v = randn(B, L, HKV, D), randn(B, L, HKV, D)
    scale = D ** -0.5
    errs: dict[str, dict[str, dict]] = {}
    cuts = torch.rand(B, L, device="cuda", generator=gen) < 4.0 / L
    seg = torch.cumsum(cuts.int(), dim=1).to(torch.int32).contiguous()
    for tag, extra, window in (("causal", (), 0), ("window", (), 512),
                               ("segments", (seg, seg), 0)):
        got = kernel_check.flash_errors(q, k, v, dout, *extra, scale=scale,
                                        causal=True, window=window)
        bad = kernel_check.failures(got)
        if bad:
            fail(f"flash kernels vs plain, {tag}: {'; '.join(bad)}")
        for name, outs in kernel_check.KERNEL_OUTPUTS.items():
            errs.setdefault(name, {})[tag] = {
                key: max(got[o][key] for o in outs)
                for key in ("max_abs_err", "max_row_err")}

    cfg = dict(scale=scale, causal=True, window=0)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, **cfg,
                                      **fa.kernel_blocks("flash_fwd", D))
    delta = fa.flash_delta(out_p, dout)

    timed = kernel_check.device_ms
    ms = {
        "flash_fwd": timed(lambda: fa.flash_fwd_cuda(q, k, v, **cfg)),
        "flash_bwd_dq": timed(lambda: fa.flash_bwd_dq_cuda(
            q, k, v, dout, lse_p, delta, **cfg)),
        "flash_bwd_dkv": timed(lambda: fa.flash_bwd_dkv_cuda(
            q, k, v, dout, lse_p, delta, **cfg)),
    }
    # the plain versions at each kernel's tiles; the plain backward
    # computes dq, dk and dv together
    plain_ms = {"flash_fwd": timed(lambda: fa.flash_fwd_plain(
        q, k, v, **cfg, **fa.kernel_blocks("flash_fwd", D)), n=1, reps=3,
        warmup=1)}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        plain_ms[name] = timed(lambda: fa.flash_bwd_plain(
            q, k, v, out_p, lse_p, dout, **cfg, **fa.kernel_blocks(name, D)),
            n=1, reps=3, warmup=1)

    # library yardstick: SDPA on [B, H, L, D], kv heads expanded outside
    # the timed region; its backward computes dq, dk and dv together
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.repeat_interleave(H // HKV, 2).transpose(1, 2).detach().requires_grad_()
    vt = v.repeat_interleave(H // HKV, 2).transpose(1, 2).detach().requires_grad_()
    gt = dout.transpose(1, 2)
    sdpa_fwd = timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    sdpa_bwd = timed(lambda: torch.autograd.grad(
        o, (qt, kt, vt), gt, retain_graph=True))
    library_ms = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                  "flash_bwd_dkv": sdpa_bwd}

    # bound: the larger of FLOPs over the bf16 peak and bytes (inputs read
    # once, outputs written once) over HBM bandwidth; causal pairs only
    pairs = B * H * L * (L + 1) / 2
    q_bytes, kv_bytes, row_bytes = 2 * B * L * H * D, 2 * B * L * HKV * D, 4 * B * H * L
    work = {
        "flash_fwd": (4 * D * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        "flash_bwd_dq": (6 * D * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        "flash_bwd_dkv": (8 * D * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
    }
    meta = {
        "flash_fwd": ("kubeflow_tpu_torch/ops/csrc/flash_fwd.cu", f"{SRC}:140"),
        "flash_bwd_dq": ("kubeflow_tpu_torch/ops/csrc/flash_bwd.cu", f"{SRC}:305"),
        "flash_bwd_dkv": ("kubeflow_tpu_torch/ops/csrc/flash_bwd_dkv.cu", f"{SRC}:362"),
    }
    rows = []
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": None,
            "tile": {d: list(t) for d, t in fa.KERNEL_TILES[name].items()},
            "registers": {d: r.get("registers")
                          for d, r in sorted(ptxas[name].items())},
            "spill_bytes": {d: r.get("spill_bytes")
                            for d, r in sorted(ptxas[name].items())},
            "max_abs_err": errs[name]["causal"]["max_abs_err"],
            "max_row_err": {t: e["max_row_err"] for t, e in errs[name].items()},
            "max_abs_err_window": errs[name]["window"]["max_abs_err"],
            "max_abs_err_segments": errs[name]["segments"]["max_abs_err"],
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms[name],
        })
        print(f"kernel {name} {fa.KERNEL_TILES[name][D]}: {ms[name]:.3f} ms "
              f"(bound {max(t_ops, t_bytes):.3f}"
              f" ms, plain {plain_ms[name]:.1f} ms, sdpa {library_ms[name]:.3f}"
              f" ms), errors {errs[name]}", flush=True)
    bwd = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
    print(f"backward: dq + dk/dv {bwd:.3f} ms against sdpa's whole backward "
          f"{sdpa_bwd:.3f} ms ({bwd / sdpa_bwd:.2f}x)", flush=True)
    return rows


def head_check() -> None:
    """The LM head on the card (bf16 GEMM, f32 out) against its plain
    formula (f32 GEMM of the rounded operands), same card tensors, at one
    main-path chunk: x [8, 256, 2048] bf16, kernel [2048, 32000] f32."""
    import torch

    from kubeflow_tpu_torch.ops import kernel_check
    from kubeflow_tpu_torch.ops.xent import head_logits, head_logits_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(B, L // 8, 2048, device="cuda", generator=gen).to(
        torch.bfloat16)
    w = torch.randn(2048, 32000, device="cuda", generator=gen) * 0.02
    g = torch.randn(B, L // 8, 32000, device="cuda", generator=gen)
    res = {}
    for name, fn in (("card", head_logits), ("plain", head_logits_plain)):
        xi = x.detach().requires_grad_()
        wi = w.detach().requires_grad_()
        logits = fn(xi, wi, torch.bfloat16).reshape(g.shape)
        logits.backward(g)
        res[name] = (logits.detach(), xi.grad, wi.grad)
    out = {}
    for i, what in enumerate(("logits", "dx", "dkernel")):
        got, want = res["card"][i], res["plain"][i]
        if got.dtype != want.dtype:
            fail(f"LM head {what}: {got.dtype} on the card, {want.dtype} "
                 "in the plain formula")
        out[what] = check_rows(f"LM head {what}", got, want,
                               kernel_check.ROW_TOL)["max_row_err"]
    print(f"head check: bf16 head GEMM vs plain formula, max row err {out}",
          flush=True)


def reference_check() -> None:
    """llama-1b widths, 2 layers, 256 tokens: flash kernel vs reference
    attention through the whole model, same weights."""
    import torch

    from kubeflow_tpu_torch.models.registry import get_model

    tokens = torch.randint(0, 32000, (1, 256), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    logits = {}
    for impl in ("flash", "reference"):
        model = get_model("llama-1b", device="cuda", seed=0, n_layers=2,
                          attention_impl=impl)
        with torch.no_grad():
            logits[impl] = model(tokens)
        del model
    got, want = logits["flash"], logits["reference"]
    if got.shape != (1, 256, 32000) or got.dtype != torch.float32:
        fail(f"logits {tuple(got.shape)} {got.dtype}")
    e = check_rows("llama-1b 2-layer logits flash vs reference", got, want,
                   REF_ROW_TOL)
    print(f"reference check: 2-layer llama-1b logits, flash vs reference "
          f"attention, max row err {e['max_row_err']:.4g}, max abs err "
          f"{e['max_abs_err']:.4g}", flush=True)


def remat_check(fa) -> None:
    """2 layers at llama-1b width, bf16, one batch [B, L], 8 xent chunks:
    the loss and every gradient under each remat policy against no
    remat, and the flash launches each policy makes."""
    import torch

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import kernel_check
    from kubeflow_tpu_torch.ops.xent import chunked_lm_xent

    layers = 2
    gen = torch.Generator(device="cuda").manual_seed(3)
    tok = torch.randint(0, 32000, (B, L + 1), device="cuda", generator=gen)
    want = None
    for policy in (None, *REMAT_POLICIES):
        kw = {} if policy is None else {"remat": True, "remat_policy": policy}
        model = get_model("llama-1b", device="cuda", seed=0, n_layers=layers,
                          **kw)
        fa.reset_launches()
        hidden = model(tok[:, :-1], return_hidden=True)
        loss, _ = chunked_lm_xent(hidden, model.lm_head.kernel, tok[:, 1:], 8,
                                  compute_dtype=model.cfg.dtype)
        del hidden
        loss.backward()
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        got = {"loss": loss.detach().reshape(1, 1),
               **{n: p.grad for n, p in model.named_parameters()}}
        del model, loss
        if not torch.isfinite(got["loss"]).all():
            fail(f"remat {policy}: loss {got['loss'].item()}")
        fwd = (2 if policy == "full" else 1) * layers
        if launches != {"flash_fwd": fwd, "flash_bwd_dq": layers,
                        "flash_bwd_dkv": layers}:
            fail(f"remat {policy}: launches {launches}, want {fwd} forward "
                 f"and {layers} of each backward kernel")
        if want is None:
            want = got
            continue
        worst_row = worst_abs = 0.0
        for name, g in got.items():
            row = g.shape[-1]
            e = check_rows(f"remat {policy}: {name}", g.reshape(-1, row),
                           want[name].reshape(-1, row), kernel_check.ROW_TOL)
            worst_row = max(worst_row, e["max_row_err"])
            worst_abs = max(worst_abs, e["max_abs_err"])
        print(f"remat check {policy}: loss and {len(got) - 1} gradients vs no "
              f"remat, max row err {worst_row:.3g}, max abs diff "
              f"{worst_abs:.3g}; launches {launches}", flush=True)
        del got
    del want
    gc.collect()
    torch.cuda.empty_cache()


def main_path(fa, _build, cfg: dict, tag: str) -> tuple[dict, float]:
    """Train `cfg` through the port launcher; every kernel must launch
    once per layer per step and the loss be finite. Returns the launches
    and the mean metered step time (s)."""
    from kubeflow_tpu_torch.runtime import launcher

    path = _build.build_dir() / f"chip_smoke_{tag}.json"
    path.write_text(json.dumps(cfg))
    buf = io.StringIO()
    fa.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = launcher.main(["--config", str(path)])
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    print(buf.getvalue(), end="", flush=True)
    if rc != 0:
        fail(f"launcher exit {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])["summary"]
    loss = summary["final"].get("loss")
    if loss is None or not math.isfinite(loss):
        fail(f"main path loss {loss}")
    for name, n in launches.items():
        if n != LAYERS * STEPS:
            fail(f"{name} launched {n} times in {STEPS} steps, want "
                 f"{LAYERS * STEPS}: the main path did not run the kernel")
    tokens_s = summary["examples_per_sec"] * L
    mfu = summary["mfu"]
    print(f"main path {tag} ({cfg['optimizer']}, remat "
          f"{cfg.get('remat') and cfg['remat_policy']}): llama-1b seq {L} "
          f"batch {B}, {STEPS} steps in {wall:.1f}s; step "
          f"{summary['step_time_s'] * 1e3:.1f} ms, {tokens_s:.0f} tokens/s, "
          f"mfu {'n/a' if mfu is None else f'{mfu:.4f}'}, final loss "
          f"{loss:.4f}, launches {launches}", flush=True)
    return launches, summary["step_time_s"]


def grad_accum_check(fa) -> None:
    """The pinned config at ACCUM_LAYERS layers, grad_accum_steps 2:
    each kernel launches once per layer per microbatch."""
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    cfg = TrainConfig.from_dict({
        **MAIN_PATH, "grad_accum_steps": 2, "total_steps": ACCUM_STEPS,
        "model_kwargs": {**MAIN_PATH["model_kwargs"],
                         "n_layers": ACCUM_LAYERS}})
    trainer = Trainer(cfg, device="cuda")
    fa.reset_launches()
    summary = trainer.fit()
    launches = dict(fa.LAUNCHES)
    loss = summary["final"].get("loss")
    if loss is None or not math.isfinite(loss):
        fail(f"grad accumulation: loss {loss}")
    want = 2 * ACCUM_LAYERS * ACCUM_STEPS
    if set(launches.values()) != {want}:
        fail(f"grad accumulation: launches {launches}, want {want} each")
    print(f"grad accumulation: {ACCUM_LAYERS} layers, 2 microbatches of "
          f"{B // 2}, {ACCUM_STEPS} steps, final loss {loss:.4f}, launches "
          f"{launches}", flush=True)


KINDS = (  # profile phase: kernel name -> kind, first match wins
    ("flash attention", ("flash_",)),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
    ("softmax/xent", ("softmax", "logsumexp", "nll", "cross_entropy")),
    ("reduction", ("reduce",)),
    ("elementwise/copy", ("elementwise", "vectorized", "copy", "cat",
                          "fill", "index", "embedding", "memcpy", "memset")),
)


def _kernel_ms(prof, steps: int) -> dict[str, float]:
    """Device time per step of each kernel a torch.profiler run saw."""
    import torch

    kernels: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0)
        # kernels only: a user annotation's device range spans kernels
        # that are counted already
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / steps
    return kernels


def profile_phase(cfg: dict, tag: str, steps: int = 3) -> None:
    """Device time of a step of `cfg` by kind of kernel, under
    torch.profiler, the device's busy share of the step (the rest is the
    device idle, waiting on the host) and the peak device memory of the
    warm-up and profiled steps; then the optimizer update alone: `steps`
    updates from one step's gradients, profiled by themselves (device
    time of their kernels, and the host clock around each update)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(TrainConfig.from_dict(cfg), device="cuda")
    batch = next(trainer._device_iter(trainer.data_iter()))
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = _kernel_ms(prof, steps)
    device_ms = sum(kernels.values())
    if device_ms == 0:
        fail("the profiler saw no device time")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=activities) as prof_opt:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.opt.step()
            torch.cuda.synchronize()
        opt_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    optimizer_ms = sum(_kernel_ms(prof_opt, steps).values())
    by_kind: dict[str, float] = {}
    for name, ms in kernels.items():
        kind = next((k for k, keys in KINDS
                     if any(key in name.lower() for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    print(f"profile {tag} ({cfg['optimizer']}, remat "
          f"{cfg.get('remat') and cfg['remat_policy']}): one step, top "
          "kernels:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f} ms  {name[:110]}")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  [{kind}] {100 * ms / device_ms:.1f}%")
    print(f"  optimizer update alone: {optimizer_ms:.3f} ms of kernels, "
          f"{opt_wall_ms:.3f} ms on the host clock")
    print(f"profile {tag}: " + json.dumps({
        "step_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms, "by_kind_ms": by_kind,
        "optimizer_ms": optimizer_ms, "optimizer_wall_ms": opt_wall_ms,
        "peak_mem_gb": peak_gb}), flush=True)
    del trainer, batch, prof, prof_opt
    gc.collect()
    torch.cuda.empty_cache()


def _left_padded(prompts: list[list[int]], p: int):
    import torch

    rows = [[0] * (p - len(r)) + r for r in prompts]
    pads = [p - len(r) for r in prompts]
    return (torch.tensor(rows, device="cuda"),
            torch.tensor(pads, device="cuda"))


def _decode_all(dec, prompts: list[list[int]]) -> list[list[int]]:
    """Every prompt through a SlotDecoder at once, one thread each."""
    import threading

    outs: list = [None] * len(prompts)

    def go(i: int) -> None:
        try:
            outs[i] = dec.submit(prompts[i])
        except Exception as e:  # noqa: BLE001 - reported below
            outs[i] = e

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    bad = [o for o in outs if not isinstance(o, list)]
    if bad:
        fail(f"slot decoder: {bad[0]!r}")
    return outs


def serving_check() -> None:
    """Phase 9: decode and the slot decoder against generate() and the
    prefill oracle, in f32 at gpt-350m width and CHECK_LAYERS layers;
    the quantized runs against the f32 run; then the same at bf16."""
    import torch

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import kernel_check
    from kubeflow_tpu_torch.runtime.generate import (
        generate, init_cache, prefill_per_token, prefill_scan)
    from kubeflow_tpu_torch.serving.continuous import SlotDecoder
    from kubeflow_tpu_torch.serving.quant import QuantizedModel, quantize_params

    p, n = CHECK_P, CHECK_N
    rng = random.Random(1)
    ragged = [[rng.randrange(1, SERVE["vocab"]) for _ in range(k)]
              for k in (5, p // 4 + 1, p // 2 + 1, p, 3 * p // 4, 1)]
    shared = [rng.randrange(1, SERVE["vocab"]) for _ in range(p)]
    prompts = ragged + [shared, shared]      # full hit, then copy-on-write

    def model(dtype="float32", **kw):
        m = get_model(SERVE["model"], device="cuda", seed=0,
                      n_layers=CHECK_LAYERS, vocab_size=SERVE["vocab"],
                      max_seq_len=p + n, dtype=dtype, **kw)
        m.load_state_dict(weights)
        return m

    weights = get_model(SERVE["model"], device="cuda", seed=0,
                        n_layers=CHECK_LAYERS, vocab_size=SERVE["vocab"],
                        max_seq_len=p + n, dtype="float32").state_dict()
    toks, pads = _left_padded(prompts, p)

    def tokens(m, params=None):
        with torch.no_grad():
            return generate(m, params, toks, max_new_tokens=n,
                            pad_len=pads)[:, p:].tolist()

    def agree(a, b) -> float:
        pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
        return sum(x == y for x, y in pairs) / len(pairs)

    base = model()
    want = tokens(base)
    dec = SlotDecoder(base, None, slots=4, prompt_len=p, max_new_tokens=n)
    try:
        got = _decode_all(dec, prompts)
    finally:
        dec.close()
    if got != want:
        fail(f"dense slot decoder vs generate: {agree(got, want):.3f} of "
             "tokens equal, want all (f32)")
    pages = 4 * -(-(p + n) // CHECK_PAGE) + 2 * p // CHECK_PAGE + 1
    paged = model(kv_pages=pages, kv_page_size=CHECK_PAGE)
    dec = SlotDecoder(paged, None, slots=4, prompt_len=p, max_new_tokens=n)
    try:
        got = _decode_all(dec, ragged)
        got += [dec.submit(shared), dec.submit(shared)]
        st = dec.stats()
        dec.alloc.check()
        free = dec.alloc.available()
    finally:
        dec.close()
    if got != want:
        fail(f"paged slot decoder vs generate: {agree(got, want):.3f} of "
             "tokens equal, want all (f32)")
    if st["prefix_hit_pages"] < p // CHECK_PAGE or st["cow_clones"] < 1:
        fail(f"paged: prefix reuse or copy-on-write did not run: {st}")
    if free != pages - 1:
        fail(f"paged: {free} of {pages - 1} pages free for admission at "
             "the end")
    with torch.no_grad():
        logits = {}
        for dtype in ("float32", "bfloat16"):
            m = base if dtype == "float32" else model(dtype)
            for name, fn in (("chunked", prefill_scan),
                             ("per_token", prefill_per_token)):
                _, logits[dtype, name] = fn(m, None, init_cache(m, len(prompts)),
                                            toks, pads)
    e32 = check_rows("f32 chunked prefill vs per-token", logits["float32", "chunked"],
                     logits["float32", "per_token"], PREFILL_ROW_TOL)
    e16 = check_rows("bf16 chunked prefill vs per-token",
                     logits["bfloat16", "chunked"],
                     logits["bfloat16", "per_token"], REF_ROW_TOL)
    mixed = kernel_check.errors(logits["bfloat16", "chunked"],
                                logits["float32", "chunked"])
    kv8 = agree(tokens(model(kv_cache_dtype="int8")), want)
    if kv8 < QUANT_AGREE:
        fail(f"the int8-cache run agrees with f32 on {kv8:.3f} of tokens, "
             f"want >= {QUANT_AGREE}")
    qm = QuantizedModel(base)
    qp = quantize_params(base.state_dict(), base.cfg.head_dim)
    w8 = agree(tokens(qm, qp), want)
    with torch.no_grad():
        full = base.apply(None, toks, decode_index=0, pad_len=pads,
                          cache=init_cache(base, len(prompts)))
        quant = qm.apply(qp, toks, decode_index=0, pad_len=pads,
                         cache=init_cache(base, len(prompts)))
    corr = torch.corrcoef(torch.stack([full.flatten(), quant.flatten()]))[
        0, 1].item()
    del full, quant
    if not corr > QUANT_CORR:
        fail(f"int8-weight logits correlate with f32 at {corr:.5f}, want > "
             f"{QUANT_CORR}")
    bf = model("bfloat16")
    want16 = tokens(bf)
    dec = SlotDecoder(bf, None, slots=4, prompt_len=p, max_new_tokens=n)
    try:
        got16 = _decode_all(dec, prompts)
    finally:
        dec.close()
    print(f"serving check ({SERVE['model']} width, {CHECK_LAYERS} layers, "
          f"{len(prompts)} prompts, P {p}, N {n}): f32 slot decoder dense "
          f"and paged == generate; paged {st['prefix_hit_pages']} prefix "
          f"pages hit, {st['cow_clones']} copy-on-write; prefill chunked vs "
          f"per-token row err f32 {e32['max_row_err']:.3g}, bf16 "
          f"{e16['max_row_err']:.3g}; generated tokens equal to f32's: "
          f"int8 cache {kv8:.3f}, int8 weights {w8:.3f} (not held; their "
          f"prompt logits correlate at {corr:.5f}); bf16 vs f32 logits row err "
          f"{mixed['max_row_err']:.3g}, bf16 tokens equal to f32's "
          f"{agree(want16, want):.3f}, bf16 slot decoder equal to bf16 "
          f"generate {agree(got16, want16):.3f}", flush=True)
    del base, paged, bf, weights
    gc.collect()
    torch.cuda.empty_cache()


SERVE_OPS = (  # tick profile: CPU op -> kind (device time of its kernels)
    ("projection GEMMs and LM head", ("aten::mm", "aten::addmm")),
    ("attention bmm (scores, probs x values)", ("aten::bmm",)),
    ("sampling", ("aten::argmax", "aten::multinomial", "aten::sort")),
)


def tick_profile(dec, ticks: int = 8, timed: int = 16) -> dict:
    """Every slot of `dec` busy (prefilled at the serving prompt
    length), then `timed` ticks back to back on the host clock and
    `ticks` more under torch.profiler: device time per tick by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.serve_bench import bench_prompts
    from kubeflow_tpu_torch.serving.quant import (
        QuantizedModel, dequantize_params)

    s, p = dec.S, dec.P
    prompts = bench_prompts(s, p, SERVE["vocab"])
    toks, pads = _left_padded(prompts, p)
    with torch.no_grad():
        st = dec._fresh_state()
        cache_k, logits_k = dec._prefill(dec._params, toks, pads)
        slots = torch.arange(s, device="cuda")
        st = dec._install(st, cache_k, logits_k, slots, pads,
                          torch.full((s,), dec.N, device="cuda"))
        del cache_k
        for _ in range(2):
            st = dec._tick(dec._params, st)

        def host_ms(params, n):
            nonlocal st
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                st = dec._tick(params, st)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        tick_ms = host_ms(dec._params, timed)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(ticks):
                st = dec._tick(dec._params, st)
            torch.cuda.synchronize()
        # the same ticks with the weights dequantized once, up front:
        # what the per-tick dequantization costs
        plain_ms = None
        if isinstance(dec.model, QuantizedModel):
            quantized, dec.model = dec.model, dec.model._model
            try:
                plain_ms = host_ms(dequantize_params(dec._params), timed)
            finally:
                dec.model = quantized
    kernels = _kernel_ms(prof, ticks)
    device_ms = sum(kernels.values())
    if device_ms == 0:
        fail("the profiler saw no device time in the decode ticks")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.3f} ms/tick  {name[:110]}")
    by_kind = {}
    for evt in prof.key_averages():
        for kind, names in SERVE_OPS:
            if evt.key in names:
                by_kind[kind] = by_kind.get(kind, 0.0) + getattr(
                    evt, "device_time_total", 0.0) / 1e3 / ticks
    by_kind["elementwise, casts, dequantization, gathers, softmax"] = (
        device_ms - sum(by_kind.values()))
    active = int((st.remaining > 0).sum())
    if active != s:
        fail(f"tick profile: {active} of {s} slots active")
    return {"host_ms_per_tick": tick_ms, "device_ms_per_tick": device_ms,
            "device_busy_share": device_ms / tick_ms, "by_kind_ms": by_kind,
            "host_ms_per_tick_weights_dequantized_once": plain_ms,
            "launches_per_tick": sum(
                evt.count for evt in prof.key_averages()
                if evt.device_type == torch.autograd.DeviceType.CUDA
                and getattr(evt, "self_device_time_total", 0) > 0) / ticks}


def serving_pinned(card: str, tag: str = "pinned serving",
                   requests: int = SERVE["requests"], warm: bool = True,
                   profile: bool = True, cache_bytes: int | None = None,
                   **extra) -> tuple[dict, list]:
    """The pinned serving point behind the ModelServer, over HTTP on
    127.0.0.1 (`extra`: more serve_lm_generator options, e.g. the
    rolling cache or a draft model): a warm-up (one predict of each
    power of two up to the concurrency, or of two instances when `warm`
    is false), then `requests` single-instance predicts at concurrency
    16. Holds every response and, when given, the decode cache's bytes;
    returns the result line and the outputs in prompt order."""
    import urllib.request

    import torch

    from kubeflow_tpu_torch.serve_bench import (
        bench_prompts, closed_loop, spec_stats, warm_up)
    from kubeflow_tpu_torch.serving.server import (
        ModelServer, serve_lm_generator)

    sv = SERVE
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    served = serve_lm_generator(
        "chat", sv["model"], prompt_len=sv["prompt_len"],
        max_new_tokens=sv["max_new"], continuous_batching=True,
        decode_slots=sv["slots"], param_dtype=sv["param_dtype"],
        vocab_size=sv["vocab"], seed=0, device="cuda", **extra)
    server = ModelServer()
    server.register(served)
    svc = server.serve(host="127.0.0.1", port=0).serve_background()
    url = f"http://127.0.0.1:{svc.port}/v1/models/chat:predict"

    def post(instances: list) -> list:
        req = urllib.request.Request(
            url, data=json.dumps({"instances": instances}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=900) as resp:
            return json.loads(resp.read())["predictions"]

    try:
        prompts = bench_prompts(requests, sv["prompt_len"], sv["vocab"])
        if warm:
            warm_up(post, prompts, sv["concurrency"])
        else:
            post([{"tokens": p} for p in prompts[:2]])
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        latencies, outs, wall = closed_loop(
            lambda pr: post([{"tokens": pr}])[0], prompts, sv["concurrency"])
        for out in outs:
            if len(out) != sv["max_new"] or not all(
                    isinstance(t, int) and 0 <= t < sv["vocab"] for t in out):
                fail(f"{tag}: bad response {out}")
        dec = served.decoder()
        stats = dec.stats()
        peak = torch.cuda.max_memory_allocated() / 1e9
        if cache_bytes is not None and stats["cache_bytes"] != cache_bytes:
            fail(f"{tag}: decode cache holds {stats['cache_bytes']} bytes, "
                 f"want {cache_bytes}")

        def pct(q: float) -> float:
            return latencies[min(len(latencies) - 1, int(q * len(latencies)))]

        result = {
            "mode": "continuous", "model": sv["model"],
            "param_dtype": sv["param_dtype"], "slots": sv["slots"],
            "concurrency": sv["concurrency"], "requests": requests,
            "prompt_len": sv["prompt_len"], "max_new_tokens": sv["max_new"],
            **extra,
            "tokens_per_sec": requests * sv["max_new"] / wall,
            "requests_per_sec": requests / wall,
            "p50_ms": pct(0.50) * 1e3, "p95_ms": pct(0.95) * 1e3,
            "p99_ms": pct(0.99) * 1e3, "wall_s": wall,
            "setup_and_warmup_s": setup_s, "peak_mem_gb": peak,
            "cache_bytes": stats["cache_bytes"],
            "completed": stats["completed"], "card": card,
            **(spec_stats(stats) if stats["speculative"] else {}),
        }
        print(f"{tag}: " + json.dumps(result), flush=True)
        if profile:
            prof = tick_profile(dec)
            print(f"{tag} ticks ({sv['slots']} slots busy): host "
                  f"{prof['host_ms_per_tick']:.2f} ms/tick, device "
                  f"{prof['device_ms_per_tick']:.2f} ms/tick (busy "
                  f"{100 * prof['device_busy_share']:.0f}%), "
                  f"{prof['launches_per_tick']:.0f} kernel launches/tick; "
                  "host "
                  f"{prof['host_ms_per_tick_weights_dequantized_once']:.2f} "
                  "ms/tick with the weights dequantized once")
            for kind, ms in sorted(prof["by_kind_ms"].items(),
                                   key=lambda kv: -kv[1]):
                print(f"  {ms:9.3f} ms  [{kind}]")
            print(f"{tag} ticks: " + json.dumps(prof), flush=True)
    finally:
        svc.shutdown()
        server.close()
    del served
    gc.collect()
    torch.cuda.empty_cache()
    return result, outs


def entry_phase(fa) -> tuple[dict, dict]:
    """The entry() twin on the card: logits [2, 256, 8192], finite, with
    one flash forward launch per layer; the flash forward held against
    its plain version at this path's shape ([2, 256, 12, 64], 12 kv
    heads) and timed there; then the same config with random weights
    (seed 0), flash against reference attention, per row. Returns the
    entry call's launch counts."""
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch import entry as E
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import kernel_check

    t0 = time.perf_counter()
    fn, (params, tokens) = E.entry()
    fa.reset_launches()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    layers = E.CONFIG["n_layers"]
    if tuple(logits.shape) != (2, 256, 8192) or not torch.isfinite(
            logits).all():
        fail(f"entry: logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    if launches != {"flash_fwd": layers, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}:
        fail(f"entry: launches {launches}, want {layers} flash_fwd")
    del fn, params, logits
    # the kernel at this path's shape against its plain version
    b, l, h = 2, 256, 12
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    q, k, v, dout = randn(b, l, h, D), randn(b, l, h, D), randn(b, l, h, D), \
        randn(b, l, h, D)
    cfg = dict(scale=D ** -0.5, causal=True, window=0)
    errs = kernel_check.flash_errors(q, k, v, dout, **cfg)
    bad = kernel_check.failures(errs)
    if bad:
        fail(f"entry shape: flash kernels vs plain: {'; '.join(bad)}")
    timed = kernel_check.device_ms
    pairs = b * h * l * (l + 1) / 2
    t_ops = 4 * D * pairs / PEAK_BF16 * 1e3
    t_bytes = (2 * 4 * b * l * h * D + 4 * b * h * l) / PEAK_BYTES * 1e3
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    at_shape = {
        "shape": [b, l, h, D], "kv_heads": h,
        "max_row_err": max(errs[o]["max_row_err"]
                           for o in kernel_check.KERNEL_OUTPUTS["flash_fwd"]),
        "ms": timed(lambda: fa.flash_fwd_cuda(q, k, v, **cfg)),
        "plain_ms": timed(lambda: fa.flash_fwd_plain(
            q, k, v, **cfg, **fa.kernel_blocks("flash_fwd", D)),
            n=3, reps=3, warmup=1),
        "library_ms": timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    # random weights: flash against reference attention through the model
    toks = torch.randint(0, 8192, (2, 256), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(5))
    out = {}
    for impl in ("auto", "reference"):
        m = get_model("gpt-125m", device="cuda", seed=0, attention_impl=impl,
                      **E.CONFIG)
        with torch.no_grad():
            out[impl] = m(toks)
        del m
    e = check_rows("entry config, random weights, flash vs reference",
                   out["auto"], out["reference"], REF_ROW_TOL)
    print(f"entry: logits [2, 256, 8192] finite, launches {launches}; flash "
          f"fwd at [2, 256, 12, 64] vs plain row err "
          f"{at_shape['max_row_err']:.3g}, {at_shape['ms']:.4f} ms (plain "
          f"{at_shape['plain_ms']:.3f}, sdpa {at_shape['library_ms']:.4f}, "
          f"bound {at_shape['bound_ms']:.4f} ms by {at_shape['bound_by']}); "
          f"random weights flash vs reference row err {e['max_row_err']:.3g}"
          f"; {time.perf_counter() - t0:.1f} s", flush=True)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return launches, at_shape


def _check_model(name: str = SERVE["model"], layers: int = CHECK_LAYERS,
                 seed: int = 0, **kw):
    from kubeflow_tpu_torch.models.registry import get_model

    return get_model(name, device="cuda", seed=seed, n_layers=layers,
                     vocab_size=SERVE["vocab"], dtype="float32", **kw)


def rolling_check() -> None:
    """gpt-350m width, CHECK_LAYERS layers, f32: with window ROLL_W and
    prompts of ROLL_P tokens decoding ROLL_N more (the cache wraps
    twice), the rolling cache's greedy tokens equal the full cache's
    under the same window, for generate() and the slot decoder, with
    the dense and the int8 cache; the rolling cache is W-sized."""
    import torch

    from kubeflow_tpu_torch.runtime.generate import generate, init_cache
    from kubeflow_tpu_torch.serving.continuous import SlotDecoder

    t0 = time.perf_counter()
    rng = random.Random(2)
    prompts = [[rng.randrange(1, SERVE["vocab"]) for _ in range(k)]
               for k in (ROLL_P, ROLL_P - 5, 3, ROLL_P - 1)]
    toks, pads = _left_padded(prompts, ROLL_P)
    seq = ROLL_P + ROLL_N
    report = []
    for kv in ("auto", "int8"):
        kw = dict(max_seq_len=seq, attention_window=ROLL_W,
                  kv_cache_dtype=kv)
        full = _check_model(**kw)
        roll = _check_model(rolling_kv_cache=True, **kw)
        shapes = {tuple(t.shape[:2]) for t in init_cache(roll, 2).values()}
        if shapes != {(2, ROLL_W)}:
            fail(f"rolling {kv}: cache shapes {shapes}, want [2, {ROLL_W}]")
        with torch.no_grad():
            want = generate(full, None, toks, max_new_tokens=ROLL_N,
                            pad_len=pads)[:, ROLL_P:].tolist()
            got = generate(roll, None, toks, max_new_tokens=ROLL_N,
                           pad_len=pads)[:, ROLL_P:].tolist()
        if got != want:
            fail(f"rolling {kv}: generate tokens differ from the full "
                 "cache's under the same window (f32)")
        dec = SlotDecoder(roll, None, slots=2, prompt_len=ROLL_P,
                          max_new_tokens=ROLL_N)
        try:
            slot = _decode_all(dec, prompts)
            cache_bytes = dec.stats()["cache_bytes"]
        finally:
            dec.close()
        if slot != want:
            fail(f"rolling {kv}: slot decoder tokens differ from the full "
                 "cache's generate (f32)")
        report.append(f"{kv}: {cache_bytes} cache bytes")
        del full, roll
    print(f"rolling check ({SERVE['model']} width, {CHECK_LAYERS} layers, "
          f"f32, W {ROLL_W}, {len(prompts)} prompts of up to {ROLL_P} + "
          f"{ROLL_N} new): rolling == full cache for generate() and the "
          f"slot decoder, dense and int8 ({'; '.join(report)}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()


def speculative_check() -> None:
    """CHECK_LAYERS layers, f32: speculative_generate and the lockstep
    slot decoder, dense and paged target, equal the target's greedy
    generate(), with the target's own weights as the draft (every
    proposal accepted: accepted == drafted) and with an independent
    draft (SPEC_DRAFT width, 2 layers, seed 1)."""
    import torch

    from kubeflow_tpu_torch.runtime.generate import generate
    from kubeflow_tpu_torch.runtime.speculative import speculative_generate
    from kubeflow_tpu_torch.serving.continuous import SlotDecoder

    t0 = time.perf_counter()
    p, n, k = CHECK_P, CHECK_N, SPEC_K
    seq = p + n + k
    rng = random.Random(3)
    prompts = [[rng.randrange(1, SERVE["vocab"]) for _ in range(m)]
               for m in (p, p // 2, 7, p - 3)]
    toks, pads = _left_padded(prompts, p)
    target = _check_model(max_seq_len=seq)
    pages = 4 * -(-seq // CHECK_PAGE) + 1
    paged = _check_model(max_seq_len=seq, kv_pages=pages,
                         kv_page_size=CHECK_PAGE)
    with torch.no_grad():
        want = generate(target, None, toks, max_new_tokens=n,
                        pad_len=pads)[:, p:].tolist()
    drafts = {"self": target,
              "independent": _check_model(SPEC_DRAFT, layers=2, seed=1,
                                          max_seq_len=seq)}
    report = []
    for dname, draft in drafts.items():
        totals = {"rounds": 0, "drafted": 0, "accepted": 0}
        for r in range(len(prompts)):
            got, st = speculative_generate(
                target, None, draft, None, toks[r:r + 1], max_new_tokens=n,
                k=k, pad_len=pads[r:r + 1])
            if got[0, p:].tolist() != want[r]:
                fail(f"speculative_generate ({dname} draft) differs from "
                     f"greedy generate on prompt {r} (f32)")
            for key in totals:
                totals[key] += st[key]
        if dname == "self" and totals["accepted"] != totals["drafted"]:
            fail(f"self-draft: accepted {totals['accepted']} of "
                 f"{totals['drafted']} drafted, want all")
        lock = {}
        for tname, tm in (("dense", target), ("paged", paged)):
            dec = SlotDecoder(tm, None, slots=2, prompt_len=p,
                              max_new_tokens=n, draft_model=draft, draft_k=k)
            try:
                got = _decode_all(dec, prompts)
                st = dec.stats()
                if tname == "paged":
                    dec.alloc.check()
            finally:
                dec.close()
            if got != want:
                fail(f"lockstep slot decoder ({dname} draft, {tname} "
                     "target) differs from greedy generate (f32)")
            lock[tname] = (f"{st['spec_tokens_accepted']}/"
                           f"{st['spec_drafted']}")
        report.append(f"{dname} draft: batch-1 {totals['accepted']}/"
                      f"{totals['drafted']} accepted in {totals['rounds']} "
                      f"rounds, lockstep dense {lock['dense']}, paged "
                      f"{lock['paged']}")
    print(f"speculative check ({SERVE['model']} width, {CHECK_LAYERS} layers, "
          f"f32, k {k}, {len(prompts)} prompts, P {p}, N {n}): batch-1 and "
          f"lockstep dense/paged == greedy generate; {'; '.join(report)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del target, paged, drafts
    gc.collect()
    torch.cuda.empty_cache()


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2] if xs else float("nan")


def _first_difference_margins(model, params, toks, pads, got: list,
                              want: list) -> tuple[list, list, int, int]:
    """The near-tie reading of rows where `got` departs from `want`:
    `model` prefills row r's left-padded prompt (`toks[r]`, `pads[r]`)
    plus the tokens both runs share and takes the top-1 minus top-2
    logit margin at every step up to the first difference. Returns the
    margins at the first differences, the margins of the agreeing steps
    before them, on how many rows the two runs' tokens are that
    forward's top two, and how many rows differ."""
    import torch

    from kubeflow_tpu_torch.runtime.generate import init_cache

    p = toks.shape[1]
    at_diff, before, top_two, rows = [], [], 0, 0
    for r, (a, b) in enumerate(zip(got, want)):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        rows += 1
        seq = torch.cat([toks[r:r + 1], torch.tensor(
            [b[:j]], device=toks.device, dtype=toks.dtype)], 1)
        with torch.no_grad():
            logits = model.apply(params, seq, decode_index=0,
                                 pad_len=pads[r:r + 1],
                                 cache=init_cache(model, 1))[0, p - 1:]
        top = logits.float().topk(2, dim=-1)
        margin = (top.values[:, 0] - top.values[:, 1]).tolist()
        at_diff.append(margin[j])
        before.extend(margin[:j])
        top_two += set(top.indices[j].tolist()) == {a[j], b[j]}
    return at_diff, before, top_two, rows


def near_tie_witness(spec_outs: list, plain_outs: list) -> str:
    """Why bf16 speculative rows differ from plain greedy ones: phase
    13b's bf16 int8 target, built again from its seed as
    serve_lm_generator builds it, prefills each differing row's
    left-padded prompt plus the tokens both runs share, and reads the
    top-1 minus top-2 logit margin at every step up to the first
    difference. A near tie has a margin far below the steps that agree,
    and the two runs' tokens are its top two."""
    import torch

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serve_bench import bench_prompts
    from kubeflow_tpu_torch.serving.quant import QuantizedModel, quantize_params

    sv = SERVE
    prompts = bench_prompts(len(spec_outs), sv["prompt_len"], sv["vocab"])
    base = get_model(sv["model"], device="cuda", seed=0,
                     vocab_size=sv["vocab"],
                     max_seq_len=sv["prompt_len"] + sv["max_new"] + SPEC_K)
    model = QuantizedModel(base)
    with torch.no_grad():
        params = quantize_params(
            {k: v.detach() for k, v in base.state_dict().items()},
            base.cfg.head_dim)
    toks, pads = _left_padded(prompts, sv["prompt_len"])
    at_diff, before, top_two, rows = _first_difference_margins(
        model, params, toks, pads, spec_outs, plain_outs)
    del base, model, params
    if not rows:
        return "no row differs"
    return (f"{rows} of {len(spec_outs)} rows differ; at the first "
            f"difference the bf16 target's top-1 - top-2 logit margin is "
            f"median {_median(at_diff):.4f} (max {max(at_diff):.4f}) against "
            f"median {_median(before):.4f} over the {len(before)} agreeing "
            f"steps before it; the two runs' tokens are that forward's top "
            f"two on {top_two} of {rows} rows")


def speculative_pinned_f32() -> str:
    """Phase 13b's point computed in f32 (TF32 off): SERVE's model at
    full depth with int8 weights, SPEC_REQUESTS prompts of up to 511
    tokens on as many busy slots, the SPEC_DRAFT int8 draft with k
    SPEC_K. The speculative server's tokens must equal a plain greedy
    server's on the same weights, token for token."""
    import torch

    from kubeflow_tpu_torch.serve_bench import (
        bench_prompts, closed_loop, spec_stats)
    from kubeflow_tpu_torch.serving.server import serve_lm_generator

    sv = SERVE
    prompts = bench_prompts(SPEC_REQUESTS, sv["prompt_len"], sv["vocab"])
    outs, st = {}, {}
    for arm, extra in (("plain", {}), ("speculative", {
            "draft_model": SPEC_DRAFT, "draft_k": SPEC_K})):
        served = serve_lm_generator(
            arm, sv["model"], prompt_len=sv["prompt_len"],
            max_new_tokens=sv["max_new"], continuous_batching=True,
            decode_slots=sv["slots"], param_dtype=sv["param_dtype"],
            vocab_size=sv["vocab"], seed=0, device="cuda", dtype="float32",
            **extra)
        try:
            _, outs[arm], _ = closed_loop(
                lambda q: served.predict([{"tokens": q}])[0], prompts,
                SPEC_REQUESTS)
            if extra:
                st = spec_stats(served.decoder().stats())
        finally:
            served.close()
        gc.collect()
        torch.cuda.empty_cache()
    bad = [r for r, (a, b) in enumerate(zip(outs["speculative"],
                                            outs["plain"])) if a != b]
    if bad:
        fail(f"speculative pinned f32: rows {bad} differ from plain greedy "
             "serving")
    return (f"{len(prompts)} requests x {sv['max_new']} tokens equal plain "
            f"greedy (f32, TF32 off); acceptance "
            f"{st['spec_tokens_accepted']}/{st['spec_drafted']} in "
            f"{st['spec_rounds']} slot-rounds")


def router_phase() -> None:
    """Two port ModelServer replicas on the card (gpt-350m width,
    CHECK_LAYERS layers, f32, continuous batching, paged cache) behind
    the port's RouterFrontend over HttpTransport: ROUTER_REQUESTS
    concurrent predicts; both replicas serve, every response equals a
    direct call of a replica on the same prompt, and the router's queue
    depth and in-flight tokens return to 0."""
    import concurrent.futures as cf
    import urllib.request

    import torch

    from kubeflow_tpu_torch.runtime.metrics import REGISTRY
    from kubeflow_tpu_torch.serving import router as R
    from kubeflow_tpu_torch.serving.server import (
        ModelServer, serve_lm_generator)

    t0 = time.perf_counter()
    slots = 8
    pages = slots * -(-(ROUTER_P + ROUTER_N) // CHECK_PAGE) + 1
    replicas = []
    for _ in range(2):
        srv = ModelServer()
        srv.register(serve_lm_generator(
            "lm", SERVE["model"], prompt_len=ROUTER_P,
            max_new_tokens=ROUTER_N, continuous_batching=True,
            decode_slots=slots, kv_pages=pages, kv_page_size=CHECK_PAGE,
            vocab_size=SERVE["vocab"], n_layers=CHECK_LAYERS,
            dtype="float32", seed=0, device="cuda"))
        replicas.append((srv, srv.serve(host="127.0.0.1", port=0)
                         .serve_background()))
    counts: dict = {}

    class Counting:
        def __init__(self, inner, name):
            self.inner, self.name = inner, name

        def predict(self, model, body, headers=None):
            counts[self.name] = counts.get(self.name, 0) + 1
            return self.inner.predict(model, body, headers)

    router = R.TokenRouter(service="chip", namespace="smoke", max_queue=64,
                           replica_token_budget=slots * (ROUTER_P + ROUTER_N))
    router.sync_endpoints(
        [{"name": f"replica-{i}", "addr": f"http://127.0.0.1:{svc.port}",
          "state": R.STATE_ACTIVE} for i, (_, svc) in enumerate(replicas)],
        transport_factory=lambda ep: Counting(R.HttpTransport(ep["addr"]),
                                              ep["name"]))
    front = R.RouterFrontend(router, max_new_tokens=ROUTER_N)
    fsvc = front.serve(host="127.0.0.1", port=0).serve_background()
    rng = random.Random(4)
    prompts = [[rng.randrange(1, SERVE["vocab"])
                for _ in range(rng.randrange(4, ROUTER_P))]
               for _ in range(ROUTER_REQUESTS)]

    def post(port: int, prompt: list[int]) -> list[int]:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/lm:predict",
            data=json.dumps({"instances": [{"tokens": prompt}]}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())["predictions"][0]

    try:
        t1 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=ROUTER_REQUESTS) as pool:
            routed = list(pool.map(lambda pr: post(fsvc.port, pr), prompts))
        routed_s = time.perf_counter() - t1
        direct = [post(replicas[0][1].port, pr) for pr in prompts]
    finally:
        fsvc.shutdown()
        for srv, svc in replicas:
            svc.shutdown()
            srv.close()
    if routed != direct:
        same = sum(a == b for a, b in zip(routed, direct))
        fail(f"router: {same} of {len(prompts)} routed responses equal a "
             "direct call (f32)")
    if len(counts) != 2 or sum(counts.values()) != len(prompts):
        fail(f"router: dispatches by replica {counts}, want both of 2 "
             f"serving {len(prompts)} requests")
    sig = R.RegistrySignals(REGISTRY)
    depth = sig.queue_depth("smoke", "chip")
    inflight = sig.inflight_tokens("smoke", "chip")
    if depth != 0 or inflight != 0 or router.queue_depth() != 0:
        fail(f"router: router_queue_depth {depth}, in-flight tokens "
             f"{inflight} after the run, want 0")
    print(f"router: 2 replicas ({SERVE['model']} width, {CHECK_LAYERS} "
          f"layers, f32, paged) behind RouterFrontend, {len(prompts)} "
          f"concurrent predicts in {routed_s:.2f} s, dispatches {counts}, "
          "every response == a direct replica call, router_queue_depth 0; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()


# -- phases 15-16: the training runtime through the launcher -----------------

RESUME_STEPS, RESUME_EVAL_STEPS, RESUME_EVAL_EVERY = 6, 2, 3
RESUME_SIGTERM_AFTER = 3          # "step 3" log line
RESUME_LOSS_RTOL = 1e-3
RESUME_DOC_TOKENS = (64, 3000)    # document lengths drawn for the shards
RESUME_SKIP_BATCHES = 10_000      # batches a restart skips, timed alone
TRACE_ROOT = ("0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331")
SERVE_CKPT_SLOTS, SERVE_CKPT_P, SERVE_CKPT_N = 4, 64, 32
# a bf16 row of phase 16 may differ from generate() only at a near tie:
# its margin at the first difference under this share of the median
# margin of the steps that agree, and the two tokens that forward's top two
NEAR_TIE_RATIO = 0.25
# what the profile window must show: each flash kernel by its name
PROFILE_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                   "flash_bwd_dkv_kernel")


def _write_resume_shards(root) -> tuple[str, str]:
    """Packed KFR1 shards from numpy draws: documents of 64-3000 tokens
    packed at seq L, enough rows for 8 training batches over two shards,
    and a separate eval shard of 2 batches (its own draw)."""
    import numpy as np

    from kubeflow_tpu_torch.runtime import records

    def packed(seed: int, rows: int):
        rng = np.random.default_rng(seed)
        docs, tok = [], np.zeros((0, L + 1), np.int32)
        while tok.shape[0] < rows:
            lo, hi = RESUME_DOC_TOKENS
            docs += [rng.integers(1, MAIN_PATH["vocab_size"], int(n),
                                  dtype=np.int32)
                     for n in rng.integers(lo, hi + 1, 16)]
            tok, seg = records.pack_documents(docs, L)
        return tok[:rows], seg[:rows]

    tok, seg = packed(0, 8 * B)
    half = tok.shape[0] // 2
    for i, sl in enumerate((slice(0, half), slice(half, None))):
        records.write_packed_token_shard(str(root / f"train-{i}.kfr"),
                                         tok[sl], seg[sl])
    tok, seg = packed(1, RESUME_EVAL_STEPS * B)
    records.write_packed_token_shard(str(root / "eval.kfr"), tok, seg)
    segments = int((seg > 0).sum()) / seg.size
    return str(root / "train-*.kfr"), f"{segments:.3f} of eval positions in a document"


def _launch(cfg: dict, root, tag: str, sigterm_after: int | None = None
            ) -> dict:
    """The port launcher as a subprocess on `cfg`, under an injected
    TRACEPARENT, with its span dump in KFTPU_TRACE_FILE; SIGTERM after
    its "step N" line when `sigterm_after` is given. Returns the exit
    code, the output, the summary and the spans."""
    import os
    import re
    import signal
    import threading

    from kubeflow_tpu_torch.obs import trace as obs_trace

    cfg_path, trace_path = root / f"{tag}.json", root / f"{tag}.trace.jsonl"
    cfg_path.write_text(json.dumps(cfg))
    env = {**os.environ, "TRACEPARENT": f"00-{TRACE_ROOT[0]}-{TRACE_ROOT[1]}-01",
           "KFTPU_TRACE_FILE": str(trace_path), "JAXRT_METRICS_PORT": "0",
           # deterministic cuBLAS: a resumed run equals an uninterrupted one
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.launcher",
         "--config", str(cfg_path)],
        cwd=str(Path(__file__).resolve().parent), env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines, signalled = [], None
    # a run that hangs without output is killed, so reading ends
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    try:
        for line in proc.stdout:
            lines.append(line)
            if (sigterm_after is not None and signalled is None
                    and re.search(rf"\bstep {sigterm_after} loss=", line)):
                proc.send_signal(signal.SIGTERM)
                signalled = time.perf_counter() - t0
        rc = proc.wait(timeout=600)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    wall = time.perf_counter() - t0
    summary_lines = [ln for ln in lines if ln.startswith('{"summary"')]
    if not summary_lines:
        print(out[-6000:], flush=True)
        fail(f"resume {tag}: exit {rc} with no summary line")
    # strictly valid JSON: no bare NaN / Infinity
    summary = json.loads(summary_lines[-1], parse_constant=lambda c: fail(
        f"resume {tag}: summary holds {c}"))["summary"]
    m = re.findall(r"flash kernel launches: (\{.*\})", out)
    launches = json.loads(m[-1]) if m else None
    spans = (obs_trace.read_jsonl(str(trace_path))
             if trace_path.exists() else [])
    return {"rc": rc, "out": out, "summary": summary, "launches": launches,
            "spans": spans, "wall": wall, "signalled": signalled}


def _check_trace(run: dict, tag: str) -> dict:
    """The dump is one connected tree: worker under the injected parent,
    train.fit under worker, train.step and train.checkpoint inside."""
    from kubeflow_tpu_torch.obs import trace as obs_trace

    spans = run["spans"]
    by_name: dict[str, list] = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    workers, fits = by_name.get("worker", []), by_name.get("train.fit", [])
    if len(workers) != 1 or workers[0].parent_id != TRACE_ROOT[1] or \
            workers[0].trace_id != TRACE_ROOT[0]:
        fail(f"resume {tag} trace: worker spans "
             f"{[(w.trace_id, w.parent_id) for w in workers]}, want one "
             f"under {TRACE_ROOT}")
    if len(fits) != 1 or fits[0].parent_id != workers[0].span_id:
        fail(f"resume {tag} trace: train.fit not under worker")
    for name in ("train.step", "train.checkpoint"):
        inside = [s for s in by_name.get(name, [])
                  if s.parent_id == fits[0].span_id]
        if not inside or len(inside) != len(by_name[name]):
            fail(f"resume {tag} trace: {name} spans "
                 f"{len(by_name.get(name, []))}, {len(inside)} under "
                 "train.fit")
    reach = obs_trace.reachable(spans, TRACE_ROOT[1])
    if any(s.span_id not in reach for s in spans):
        fail(f"resume {tag} trace: spans outside the injected tree")
    return {name: len(v) for name, v in sorted(by_name.items())}


def _want_launches(start: int, end: int, evals: int) -> dict:
    steps = end - start
    return {"flash_fwd": LAYERS * (steps + RESUME_EVAL_STEPS * evals),
            "flash_bwd_dq": LAYERS * steps, "flash_bwd_dkv": LAYERS * steps}


def _evals_in(start: int, end: int, every: int) -> int:
    return sum(1 for s in range(start + 1, end + 1) if every and s % every == 0)


def resume_phase(card: str, synthetic_step_s: float, root) -> dict:
    """Phase 15: the pinned main path at full width through the launcher
    as a subprocess, on packed shards (segment ids reach the flash
    kernels) through the native loader and the Prefetcher, with
    checkpoints, evals, a profiler window and a SIGTERM: run A is
    preempted after its "step 3" line, run B resumes it to step 6, run C
    runs 6 steps straight; B is held to C. Returns run B's launches and
    its checkpoint directory."""
    import re

    import torch

    from kubeflow_tpu_torch.ops import kernel_check
    from kubeflow_tpu_torch.runtime import checkpoint as ckpt_mod
    from kubeflow_tpu_torch.runtime import records

    t0 = time.perf_counter()
    free_gb = shutil.disk_usage(root).free / 1e9
    data_path, seg_note = _write_resume_shards(root)
    ds = records.RecordDataset(sorted(map(str, root.glob("train-*.kfr"))), B,
                               native=True)        # raises without g++
    first = next(ds)
    ds.close()
    if not ds.native or first.shape != (B, 2 * 4 * (L + 1)):
        fail(f"resume: native loader {ds.native}, batch {first.shape}")
    cfg = {**MAIN_PATH, "data_path": data_path, "packed_data": True,
           "shuffle_buffer": 16, "checkpoint_every": 2, "checkpoint_keep": 2,
           "total_steps": RESUME_STEPS, "eval_every": RESUME_EVAL_EVERY,
           "eval_steps": RESUME_EVAL_STEPS,
           "eval_data_path": str(root / "eval.kfr"),
           "checkpoint_dir": str(root / "ckpt"),
           "profile_dir": str(root / "profile"), "profile_start_step": 2,
           "profile_steps": 1}
    print(f"resume: shards written ({seg_note}), native loader, "
          f"{free_gb:.0f} GB free on the checkout's disk; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    a = _launch(cfg, root, "run_a", sigterm_after=RESUME_SIGTERM_AFTER)
    m = re.search(r"preempted at step (\d+)", a["out"])
    steps_a = ckpt_mod.list_steps(cfg["checkpoint_dir"])
    manifest = json.loads((root / "ckpt" / "manifest.json").read_text())
    if a["rc"] != 75 or not a["summary"].get("preempted") or not m:
        print(a["out"][-6000:], flush=True)
        fail(f"resume run A: exit {a['rc']} (want 75), summary "
             f"{a['summary']}, SIGTERM at {a['signalled']}")
    k = int(m.group(1))
    if k < RESUME_SIGTERM_AFTER or k >= RESUME_STEPS or not steps_a or \
            steps_a[-1] != k or manifest.get("latest_step") != k:
        fail(f"resume run A: preempted at {k}, steps on disk {steps_a}, "
             f"manifest {manifest}")
    want_a = _want_launches(0, k, _evals_in(0, k, RESUME_EVAL_EVERY))
    if a["launches"] != want_a:
        fail(f"resume run A: launches {a['launches']}, want {want_a}")
    tree_a = _check_trace(a, "A")
    traces = sorted((root / "profile").glob("*.json"))
    text = traces[0].read_text() if traces else ""
    missing = [n for n in PROFILE_KERNELS if n not in text]
    if len(traces) != 1 or missing:
        fail(f"resume run A: profile {traces}, kernels missing {missing}")

    b = _launch(cfg, root, "run_b")
    sb = b["summary"]
    ev = sb.get("eval") or {}
    if b["rc"] != 0 or sb.get("start_step") != k or sb.get("steps") != \
            RESUME_STEPS or "preempted" in sb:
        print(b["out"][-6000:], flush=True)
        fail(f"resume run B: exit {b['rc']}, summary {sb}, want start {k}")
    if ev.get("smoke") != 0.0 or not all(
            isinstance(ev.get(x), float) and math.isfinite(ev[x])
            for x in ("loss", "accuracy", "perplexity")):
        fail(f"resume run B: eval {ev}")
    want_b = _want_launches(k, RESUME_STEPS,
                            _evals_in(k, RESUME_STEPS, RESUME_EVAL_EVERY))
    if b["launches"] != want_b:
        fail(f"resume run B: launches {b['launches']}, want {want_b}")
    tree_b = _check_trace(b, "B")

    cfg_c = {**cfg, "checkpoint_dir": str(root / "ckpt_c"),
             "checkpoint_every": 0, "eval_every": 0, "profile_dir": None}
    c = _launch(cfg_c, root, "run_c")
    if c["rc"] != 0 or c["summary"].get("start_step") != 0:
        print(c["out"][-6000:], flush=True)
        fail(f"resume run C: exit {c['rc']}, summary {c['summary']}")
    want_c = _want_launches(0, RESUME_STEPS, 0)
    if c["launches"] != want_c:
        fail(f"resume run C: launches {c['launches']}, want {want_c}")

    # run B's final parameters against run C's, per row
    pb = torch.load(root / "ckpt" / str(RESUME_STEPS) / ckpt_mod.PARAMS_FILE,
                    map_location="cuda", weights_only=True)["params"]
    pc = torch.load(root / "ckpt_c" / str(RESUME_STEPS) / ckpt_mod.PARAMS_FILE,
                    map_location="cuda", weights_only=True)["params"]
    if set(pb) != set(pc):
        fail("resume: runs B and C saved different parameters")
    worst = (0.0, 0.0, "")
    for name in sorted(pb):
        g, w = pb[name].float(), pc[name].float()
        g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
        e = check_rows(f"resume: run B vs run C {name}", g, w,
                       kernel_check.ROW_TOL)
        worst = max(worst, (e["max_row_err"], e["max_abs_err"], name))
    lb, lc = sb["final"]["loss"], c["summary"]["final"]["loss"]
    if not abs(lb - lc) <= RESUME_LOSS_RTOL * abs(lc):
        fail(f"resume: final loss B {lb} vs C {lc}, beyond "
             f"{RESUME_LOSS_RTOL} relative")
    del pb, pc

    # what a restart pays before its first step: fit skips the batches
    # the earlier run consumed through token_batches, as run B did; timed
    # here for RESUME_SKIP_BATCHES batches over the looped shards (so from
    # the page cache: a cold disk's read rate comes on top), and through
    # the record reader alone, without the per-batch token arrays
    paths = sorted(map(str, root.glob("train-*.kfr")))
    skip_s = {}
    for how, it in (
            ("token_batches", records.token_batches(
                paths, B, L, shuffle_buffer=16, seed=0, loop=True,
                segmented=True)),
            ("records", records.RecordDataset(
                paths, B, shuffle_buffer=16, loop=True, native=True))):
        t = time.perf_counter()
        for _ in range(RESUME_SKIP_BATCHES):
            next(it)
        skip_s[how] = time.perf_counter() - t
        it.close()

    def logged(run, pattern):
        return [float(x) for x in re.findall(pattern, run["out"])]

    nbytes = logged(a, r"queued save at step \d+ -> .* \((\d+) bytes")
    blocking = [s.duration for run in (a, b) for s in run["spans"]
                if s.name == "train.checkpoint"]
    writes = logged(a, r"written in ([\d.]+) s") + \
        logged(b, r"written in ([\d.]+) s")
    restore_s = logged(b, r"restored step \d+ from .* in ([\d.]+) s")
    figures = {
        "preempted_at": k, "sigterm_after_s": a["signalled"],
        "checkpoint_bytes": int(nbytes[0]) if nbytes else None,
        "checkpoint_blocking_s": blocking,
        "checkpoint_write_s": writes, "restore_s": restore_s,
        "step_s_shards_prefetcher": c["summary"]["step_time_s"],
        "step_s_synthetic_phase6": synthetic_step_s,
        "resumed_vs_straight_max_row_err": worst[0],
        "resumed_vs_straight_max_abs_diff": worst[1],
        "resumed_vs_straight_worst_param": worst[2],
        "final_loss_b_c": [lb, lc],
        "eval": ev, "launches": {"A": a["launches"], "B": b["launches"],
                                 "C": c["launches"]},
        "spans": {"A": tree_a, "B": tree_b},
        "wall_s": {"A": a["wall"], "B": b["wall"], "C": c["wall"]},
        "profile_trace_mb": traces[0].stat().st_size / 1e6,
        "resume_skip": {"batches": RESUME_SKIP_BATCHES,
                        "bytes": RESUME_SKIP_BATCHES * first.size,
                        "s": skip_s},
    }
    print(f"resume ({card}): " + json.dumps(figures), flush=True)
    print(f"resume: A preempted at step {k} (exit 75), B resumed {k} -> "
          f"{RESUME_STEPS}, B == C per row (max row err {worst[0]:.3g}, "
          f"max abs diff {worst[1]:.3g} in {worst[2]}), final loss "
          f"{lb:.6f} vs {lc:.6f}; checkpoint "
          f"{figures['checkpoint_bytes']} bytes, blocking {blocking} s, "
          f"write {writes} s, restore {restore_s} s; step "
          f"{c['summary']['step_time_s'] * 1e3:.1f} ms on shards vs "
          f"{synthetic_step_s * 1e3:.1f} ms synthetic; skipping "
          f"{RESUME_SKIP_BATCHES} batches on resume "
          f"{skip_s['token_batches']:.2f} s (the record reader alone "
          f"{skip_s['records']:.2f} s); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(root / "ckpt_c", ignore_errors=True)
    shutil.rmtree(root / "profile", ignore_errors=True)
    return {"launches": b["launches"], "checkpoint_dir": root / "ckpt"}


def _serve_from_checkpoint(checkpoint_dir, prompts: list, dtype: str
                           ) -> tuple[list, list, str]:
    """4 greedy requests through serve_lm_generator(checkpoint_dir=...)
    (continuous batching, 4 slots) with `dtype` weights and compute, and
    generate() over the same prompts on the params restore_params reads,
    cast alike. Returns both token lists and, where rows differ, the
    near-tie witness (_first_difference_margins on generate()'s model),
    which fails unless every differing row is at a near tie: its
    margin under NEAR_TIE_RATIO of the agreeing steps' median and the
    two runs' tokens that forward's top two."""
    import concurrent.futures as cf

    import torch

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.runtime.checkpoint import restore_params
    from kubeflow_tpu_torch.runtime.generate import generate
    from kubeflow_tpu_torch.serving.server import cast_params, serve_lm_generator

    p, n = SERVE_CKPT_P, SERVE_CKPT_N
    served = serve_lm_generator(
        "ckpt", "llama-1b", prompt_len=p, max_new_tokens=n, device="cuda",
        checkpoint_dir=str(checkpoint_dir), param_dtype=dtype, dtype=dtype,
        continuous_batching=True, decode_slots=SERVE_CKPT_SLOTS)
    try:
        with cf.ThreadPoolExecutor(max_workers=len(prompts)) as pool:
            got = list(pool.map(
                lambda pr: [int(t) for t in
                            served.predict([{"tokens": pr}])[0]], prompts))
    finally:
        served.close()
    params, step = restore_params(str(checkpoint_dir))
    model = get_model("llama-1b", device="cuda", max_seq_len=p + n,
                      dtype=dtype)
    model.load_state_dict(params)
    cast = cast_params({k: v.detach() for k, v in model.state_dict().items()},
                       dtype)
    toks, pads = _left_padded(prompts, p)
    with torch.no_grad():
        want = generate(model, cast, toks, max_new_tokens=n,
                        pad_len=pads)[:, p:].tolist()
    at_diff, before, top_two, rows = _first_difference_margins(
        model, cast, toks, pads, got, want)
    del model, cast, params
    witness = ""
    if rows:
        med = _median(before)
        witness = (f"{rows} of {len(got)} rows differ; margin at the first "
                   f"difference max {max(at_diff):.4f} against median "
                   f"{med:.4f} over the {len(before)} agreeing steps before "
                   f"it; the runs' tokens are that forward's top two on "
                   f"{top_two} of {rows} rows")
        if top_two != rows or not max(at_diff) < NEAR_TIE_RATIO * med:
            fail(f"serve from checkpoint ({dtype}): {witness}: a row "
                 f"differs by more than a near tie (margin under "
                 f"{NEAR_TIE_RATIO}x the agreeing steps' median and the "
                 "top two)")
    return got, want, witness


def serve_checkpoint_phase(checkpoint_dir, root) -> None:
    """Phase 16: serve_lm_generator(checkpoint_dir=run B's) on llama-1b
    with continuous batching, 4 slots, 4 greedy requests of 32 new
    tokens, against generate() on the params restore_params reads: in
    f32 (TF32 off) the tokens must be equal; in bf16, the serving dtype,
    the share of equal tokens is printed and a row may differ only at a
    near tie (see _serve_from_checkpoint): the slot decoder prefills a
    request alone or beside others, generate() all four at once, and on
    a model 6 steps from random init the top two logits are often
    within bf16's rounding. A draft checkpoint directory with no step
    fails registration."""
    import torch

    from kubeflow_tpu_torch.serving.server import serve_lm_generator

    t0 = time.perf_counter()
    p, n = SERVE_CKPT_P, SERVE_CKPT_N
    rng = random.Random(7)
    prompts = [[rng.randrange(1, 32000) for _ in range(k)]
               for k in (p, p // 2, 7, 3 * p // 4)]
    got, want, _ = _serve_from_checkpoint(checkpoint_dir, prompts, "float32")
    if got != want:
        same = sum(x == y for r, s in zip(got, want) for x, y in zip(r, s))
        fail(f"serve from checkpoint (f32): {same} of {len(prompts) * n} "
             "tokens equal generate() on the restored params")
    got16, want16, witness = _serve_from_checkpoint(checkpoint_dir, prompts,
                                                    "bfloat16")
    same16 = sum(x == y for r, s in zip(got16, want16) for x, y in zip(r, s))
    empty = root / "empty_draft"
    empty.mkdir(exist_ok=True)
    try:
        serve_lm_generator("bad", "llama-1b", prompt_len=p, max_new_tokens=n,
                           device="cuda", draft_model="gpt-125m",
                           draft_checkpoint_dir=str(empty),
                           continuous_batching=True)
    except FileNotFoundError as e:
        refused = str(e)
    else:
        fail("serve from checkpoint: an empty draft checkpoint directory "
             "registered")
    print(f"serve from checkpoint: llama-1b, {SERVE_CKPT_SLOTS} slots, "
          f"{len(prompts)} greedy requests x {n} tokens; f32 == generate() "
          f"on restore_params; bf16 {same16} of {len(prompts) * n} tokens "
          f"equal ({witness or 'all rows equal'}); empty draft dir refused "
          f"({refused}); {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError as e:
        fail(f"torch missing: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    try:
        from kubeflow_tpu_torch.ops import _build
        from kubeflow_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s "
          f"({', '.join(p.name for p in paths.values())})", flush=True)
    ptxas = _build.ptxas_report(paths)
    for name, by_d in sorted(ptxas.items()):
        for d, r in sorted(by_d.items()):
            print(f"  {name} head_dim {d}: {r.get('registers')} registers "
                  f"(ptxas, at launch), {r.get('spill_bytes')} bytes spilled")
    if set(ptxas) != set(fa.LAUNCHES):
        fail(f"build log names kernels {sorted(ptxas)}, want "
             f"{sorted(fa.LAUNCHES)}")

    phase_s = {}

    def timed_phase(name, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        phase_s[name] = round(time.perf_counter() - t, 1)
        print(f"phase {name}: {phase_s[name]} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    rows = timed_phase("kernels", kernel_phase, fa, ptxas)
    timed_phase("head", head_check)
    timed_phase("reference", reference_check)
    launches = {}
    launches["entry"], at_entry = timed_phase("entry", entry_phase, fa)
    timed_phase("remat", remat_check, fa)
    step_s = {}
    for tag, cfg in (("adamw", ADAMW_PATH), ("pinned", MAIN_PATH)):
        launches[tag], step_s[tag] = timed_phase(
            f"main path {tag}", main_path, fa, _build, cfg, tag)
    timed_phase("grad accumulation", grad_accum_check, fa)
    for tag, cfg in (("pinned", MAIN_PATH), ("adamw", ADAMW_PATH)):
        timed_phase(f"profile {tag}", profile_phase, cfg, tag)
    # the training runtime: subprocess launches (their counts come from
    # each launcher's log), then serving from the resumed checkpoint
    resume_root = _build.build_dir() / "chip_smoke_resume"
    shutil.rmtree(resume_root, ignore_errors=True)
    resume_root.mkdir(parents=True)
    try:
        resumed = timed_phase("resume", resume_phase, card,
                              step_s["pinned"], resume_root)
        launches["resume"] = resumed["launches"]
        fa.reset_launches()
        timed_phase("serve from checkpoint", serve_checkpoint_phase,
                    resumed["checkpoint_dir"], resume_root)
        launches["serve_checkpoint"] = dict(fa.LAUNCHES)
    finally:
        shutil.rmtree(resume_root, ignore_errors=True)
    timed_phase("serving check", serving_check)
    # the serving paths run no flash kernel (decode attends by bmm over
    # the cache); their counts are read like every path's
    fa.reset_launches()
    _, plain_outs = timed_phase("pinned serving", serving_pinned, card,
                                cache_bytes=DENSE_CACHE_BYTES)
    launches["serving"] = dict(fa.LAUNCHES)
    timed_phase("rolling check", rolling_check)
    fa.reset_launches()
    timed_phase("rolling pinned", serving_pinned, card, tag="rolling pinned",
                cache_bytes=ROLLING_CACHE_BYTES,
                attention_window=ROLLING_WINDOW, rolling_kv_cache=True)
    launches["rolling"] = dict(fa.LAUNCHES)
    timed_phase("speculative check", speculative_check)
    fa.reset_launches()
    spec, spec_outs = timed_phase(
        "speculative pinned", serving_pinned, card, tag="speculative pinned",
        requests=SPEC_REQUESTS, warm=False, profile=False,
        cache_bytes=DENSE_CACHE_BYTES + 24 * 2 * 16 * SPEC_K * 16 * 64 * 2,
        draft_model=SPEC_DRAFT, draft_k=SPEC_K)
    launches["speculative"] = dict(fa.LAUNCHES)
    # bf16: a near-tie argmax can go either way between the verify chunk
    # and a single tick, so the share equal to plain greedy is printed
    pairs = [(a, b) for ra, rb in zip(spec_outs, plain_outs)
             for a, b in zip(ra, rb)]
    print(f"speculative pinned: acceptance {spec['acceptance_rate']:.4f} "
          f"({spec['spec_tokens_accepted']}/{spec['spec_drafted']}), "
          f"{spec['spec_rounds']} slot-rounds, "
          f"{spec['tokens_per_sec']:.1f} tokens/s, p50 "
          f"{spec['p50_ms']:.0f} ms, p95 {spec['p95_ms']:.0f} ms, peak "
          f"{spec['peak_mem_gb']:.2f} GB; tokens equal to plain greedy "
          f"(bf16, not held): {sum(a == b for a, b in pairs) / len(pairs):.3f}",
          flush=True)
    print("speculative pinned witness: " + timed_phase(
        "speculative witness", near_tie_witness, spec_outs,
        plain_outs[:SPEC_REQUESTS]), flush=True)
    print("speculative pinned f32: " + timed_phase(
        "speculative pinned f32", speculative_pinned_f32), flush=True)
    fa.reset_launches()
    timed_phase("router", router_phase)
    launches["router"] = dict(fa.LAUNCHES)
    for name in ("rolling", "speculative", "router", "serving",
                 "serve_checkpoint"):
        if any(launches[name].values()):
            fail(f"the {name} path launched flash kernels "
                 f"{launches[name]}: decode attends by bmm over the cache")
    for row in rows:
        row["launches"] = launches["pinned"][row["name"]]
        row["launches_by_path"] = {t: n[row["name"]]
                                   for t, n in launches.items()}
        if row["name"] == "flash_fwd":
            row["at_entry_shape"] = at_entry
    print("phase seconds: " + json.dumps(phase_s), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
