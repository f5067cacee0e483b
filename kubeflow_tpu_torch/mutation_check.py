"""Does the kernel check catch a wrong kernel? Planted faults, on the card.

    python -m kubeflow_tpu_torch.mutation_check

Copies the CUDA sources into `_build/mutants/<name>/` once per planted
fault, alters the copy (each fault is one text substitution that must
match exactly once), builds every copy at once, and runs the check of
chip_smoke.py's kernel phase (`kernel_check.flash_errors` at llama-1b
attention shapes: causal, window 512, segment ids) with the wrappers
routed to each altered build. The sources in the checkout are never
changed. The unaltered build must pass and every fault must fail; each
fault's errors are printed beside the limit, and beside the limit the
first version of chip_smoke.py used (3e-2 x max(1, max |ref|)), to
show which faults that one let through. Exits non-zero when the clean
build fails or a fault passes. Needs one CUDA GPU and `nvcc`.
"""

from __future__ import annotations

import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from kubeflow_tpu_torch.ops import _build, kernel_check

B, L, H, HKV, D = 8, 2048, 32, 8, 64
OLD_TOL = 3e-2

# name -> (file, text, replacement): each a fault a wrong kernel could have
FAULTS = {
    "fwd_skips_last_k_tile": (
        "flash_fwd.cu", "for (; kb < a.Lk / T::kBK; ++kb)",
        "for (; kb < a.Lk / T::kBK - 1; ++kb)"),
    "dq_skips_last_k_tile": (
        "flash_bwd.cu", "for (; kb < a.Lk / T::kBK; ++kb)",
        "for (; kb < a.Lk / T::kBK - 1; ++kb)"),
    # ds = p * dp * scale: the delta term dropped (a 2% scale error would
    # sit at dq's own limit, so that fault would not show the check)
    "dq_ds_without_delta": (
        "flash_bwd.cu", "dsc[r] = rs[kBQ + row0 + 8 * r] * a.scale;",
        "dsc[r] = 0.f;"),
    "dkv_skips_last_q_tile": (
        "flash_bwd_dkv.cu", "for (; qb < a.Lq / T::kBQ; ++qb)",
        "for (; qb < a.Lq / T::kBQ - 1; ++qb)"),
    "window_one_key_wider": (
        "flash_sm90.cuh", "return a.window > 0 ? a.window : 1 << 30;",
        "return a.window > 0 ? a.window + 1 : 1 << 30;"),
    "fwd_scale_2pct_high": (
        "flash_fwd.cu", "const float scale2 = a.scale * kLog2e;",
        "const float scale2 = a.scale * 1.02f * kLog2e;"),
    # every kernel skips the per-element mask on interior tiles; one tile
    # too generous a test takes the diagonal as interior
    "diagonal_tile_taken_as_interior": (
        "flash_sm90.cuh", "if (a.causal && k_hi > q_lo + offset) return false;",
        "if (a.causal && k_hi - 128 > q_lo + offset) return false;"),
}


def plant(name: str, edit: tuple[str, str, str] | None = None,
          kind: str = "mutants") -> dict:
    """An altered copy of the sources, built; its library paths. `edit`
    is (file, text, replacement), by default the fault `name`."""
    fname, old, new = edit or FAULTS[name]
    root = _build.build_dir() / kind / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root / "csrc")
    path = root / "csrc" / fname
    text = path.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: {old!r} found {text.count(old)} times "
                           f"in {fname}, want once")
    path.write_text(text.replace(old, new))
    return _build.build(csrc=root / "csrc", out=root)


def cases():
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    q, dout = randn(B, L, H, D), randn(B, L, H, D)
    k, v = randn(B, L, HKV, D), randn(B, L, HKV, D)
    cuts = torch.rand(B, L, device="cuda", generator=gen) < 4.0 / L
    seg = torch.cumsum(cuts.int(), dim=1).to(torch.int32).contiguous()
    args = (q, k, v, dout)
    return {"causal": (args, dict(window=0)),
            "window": (args, dict(window=512)),
            "segments": ((*args, seg, seg), dict(window=0))}


def run_cases(data) -> dict:
    """{case: {"failures": [...], "old_check_fails": bool,
    "max_row_err": {output: err}, "lse_max_abs_err": err}}"""
    report = {}
    for case, (args, kw) in data.items():
        errs = kernel_check.flash_errors(*args, scale=D ** -0.5, causal=True,
                                         **kw)
        old = [n for n, e in errs.items() if n != "lse" and
               e["max_abs_err"] > OLD_TOL * max(1.0, e["max_abs_ref"])]
        report[case] = {"failures": kernel_check.failures(errs),
                        "old_check_fails": bool(old),
                        "max_row_err": {n: e["max_row_err"]
                                        for n, e in errs.items()
                                        if n != "lse"},
                        "lse_max_abs_err": errs["lse"]["max_abs_err"]}
    return report


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mutation_check: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(FAULTS) + 1) as pool:
        clean = pool.submit(_build.build)
        planted = {n: pool.submit(plant, n) for n in FAULTS}
        clean.result()
        planted = {n: f.result() for n, f in planted.items()}
    data = cases()
    results = {"clean": run_cases(data)}
    for name, paths in planted.items():
        with _build.using(paths):
            results[name] = run_cases(data)
    ok = True
    for name, rep in results.items():
        caught = any(r["failures"] for r in rep.values())
        old = any(r["old_check_fails"] for r in rep.values())
        want = name != "clean"
        ok &= caught == want
        worst = max(max(r["max_row_err"].values()) for r in rep.values())
        # the outputs that miss their limit in some case, so a fault in
        # shared code shows which kernels it reaches
        missed = sorted({f.split(":")[0] for r in rep.values()
                         for f in r["failures"]})
        print(f"{name}: {'FAILS' if caught else 'passes'} the check "
              f"{'in ' + ', '.join(missed) + ' ' if missed else ''}"
              f"(worst row err {worst:.4g}, limits {kernel_check.ROW_TOL}, "
              f"{kernel_check.OUTPUT_TOL}); "
              f"the max-scaled check {'fails' if old else 'passes'} it"
              f"{'' if caught == want else '  <-- WRONG'}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "row_tol": kernel_check.ROW_TOL,
                      "output_tol": kernel_check.OUTPUT_TOL,
                      "results": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
