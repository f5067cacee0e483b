"""How a CUDA kernel is held against its plain version on the card.

Error is taken row by row. A row is one vector of the last axis: one
head at one position for attention, one token's logits for the LM head.
Its error is |got - want| / |want| in the L2 norm over that row. A limit
scaled by a tensor's largest value is too loose for attention under a
causal mask: the first rows see a few keys and hold values near 1, the
late rows average ~2,000 keys and hold values of a few hundredths, so
such a limit would let a late row be wrong by as much as it holds. Per
row, each is held to its own size. A row whose reference is all but zero
(norm below FLOOR times the tensor's RMS row norm) is held to that floor
instead, so exact zeros compare without dividing by zero.

ROW_TOL: bf16 has 8 significant bits, so one rounding moves a value by
at most 2^-9 (0.2%) of itself. The kernels and their plain versions
round the same operands the same way and differ in summation order and
in the exp they call, which flips a rounding now and then: a handful of
roundings per row at most. dq is held to twice that: each row of ds
sums to zero (sum_j p_ij (dp_ij - delta_i) = delta_i - delta_i), so
dq_i = sum_j ds_ij k_j cancels, and the rounding of ds is relative to
its terms, not to their sum (max row error 0.0076 of the clean kernels
at llama-1b shapes, against 0.0035 for out, PERF.md).
`python -m kubeflow_tpu_torch.mutation_check` shows on the card which
planted faults these limits catch.
"""

from __future__ import annotations

import math
import statistics

import torch

from kubeflow_tpu_torch.ops import flash_attention as fa

ROW_TOL = 1e-2
OUTPUT_TOL = {"dq": 2e-2}              # by output name; else ROW_TOL
FLOOR = 1e-3
LSE_TOL = dict(atol=1e-3, rtol=1e-3)   # f32 lse, 2,048-term sums


def device_ms(fn, n: int = 20, reps: int = 5, warmup: int = 2) -> float:
    """fn's device time per call: CUDA events around n back-to-back calls,
    divided by n; the median of reps such runs. Back to back, the host's
    work of one call (argument checks, tensor maps, the launch) overlaps
    the device's work of the one before, as on the main path."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def errors(got: torch.Tensor, want: torch.Tensor) -> dict[str, float]:
    """max_row_err (see above), max_abs_err and max_abs_ref of got
    against want. A non-finite value in got gives inf."""
    if got.shape != want.shape:
        raise ValueError(f"shape {tuple(got.shape)} vs {tuple(want.shape)}")
    g = got.detach().float().reshape(-1, got.shape[-1])
    w = want.detach().float().reshape(-1, want.shape[-1])
    norm = w.norm(dim=1)
    floor = FLOOR * norm.square().mean().sqrt()
    diff = g - w
    if not bool(torch.isfinite(g).all()):
        row = math.inf
    else:
        row = (diff.norm(dim=1) / torch.maximum(norm, floor).clamp_min(1e-30)
               ).max().item()
    return {"max_row_err": row, "max_abs_err": diff.abs().max().item(),
            "max_abs_ref": w.abs().max().item()}


def flash_errors(q, k, v, dout, qseg=None, kseg=None, *, scale, causal,
                 window=0) -> dict[str, dict[str, float]]:
    """Run the three flash kernels and their plain versions on the same
    card tensors, each plain version at its kernel's tiles
    (`KERNEL_TILES` at q's head dim); return `errors` for each of out,
    lse, dq, dk and dv. The backward kernels and both plain backward runs
    take the plain forward's lse and delta, so each kernel is held on its
    own."""
    cfg = dict(scale=scale, causal=causal, window=window)
    d = q.shape[-1]
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, qseg, kseg, **cfg,
                                      **fa.kernel_blocks("flash_fwd", d))
    dq_p, _, _ = fa.flash_bwd_plain(q, k, v, out_p, lse_p, dout, qseg, kseg,
                                    **cfg,
                                    **fa.kernel_blocks("flash_bwd_dq", d))
    _, dk_p, dv_p = fa.flash_bwd_plain(
        q, k, v, out_p, lse_p, dout, qseg, kseg, **cfg,
        **fa.kernel_blocks("flash_bwd_dkv", d))
    out, lse = fa.flash_fwd_cuda(q, k, v, qseg, kseg, **cfg)
    delta = fa.flash_delta(out_p, dout)
    dq = fa.flash_bwd_dq_cuda(q, k, v, dout, lse_p, delta, qseg, kseg, **cfg)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, dout, lse_p, delta, qseg, kseg,
                                   **cfg)
    torch.cuda.synchronize()
    return {"out": errors(out, out_p), "lse": errors(lse[..., None],
                                                     lse_p[..., None]),
            "dq": errors(dq, dq_p), "dk": errors(dk, dk_p),
            "dv": errors(dv, dv_p)}


def failures(errs: dict[str, dict[str, float]]) -> list[str]:
    """The outputs of `flash_errors` (or any name -> `errors` map; "lse"
    is held to LSE_TOL, "dq" to OUTPUT_TOL) that miss their limit."""
    bad = []
    for name, e in errs.items():
        tol = OUTPUT_TOL.get(name, ROW_TOL)
        if name == "lse":
            ok = e["max_abs_err"] <= (LSE_TOL["atol"]
                                      + LSE_TOL["rtol"] * e["max_abs_ref"])
        else:
            ok = e["max_row_err"] <= tol
        if not ok:
            limit = LSE_TOL if name == "lse" else tol
            bad.append(f"{name}: max row err {e['max_row_err']:.4g}, max abs "
                       f"err {e['max_abs_err']:.4g} (limit {limit})")
    return bad


# the outputs each kernel writes
KERNEL_OUTPUTS = {"flash_fwd": ("out", "lse"), "flash_bwd_dq": ("dq",),
                  "flash_bwd_dkv": ("dk", "dv")}
