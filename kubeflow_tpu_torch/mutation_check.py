"""Does the kernel check catch a wrong kernel? Planted faults, on the card.

    python -m kubeflow_tpu_torch.mutation_check

Copies the CUDA sources into `_build/mutants/<name>/` once per planted
fault, alters the copy (each fault is one text substitution that must
match exactly once), builds every copy at once, and runs the check of
chip_smoke.py's kernel phase (`kernel_check.flash_errors`: causal,
window 512, segment ids; at llama-1b attention shapes in bf16, and at
smaller shapes for each other family of instantiations: f16 at head_dim
64 on the wgmma kernels, f32 at 64 and at 256 on the SIMT kernels of
flash_simple.cu, bf16 at 256 on the wgmma forward and dq and the split
dk/dv of flash_bwd_dkv_split.cu) with the wrappers routed to each
altered build. The sources in the checkout are never changed. The
unaltered build must pass and every fault must fail, a fault of
`MUST_CATCH` in the cases it names; each
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
    # the SIMT kernels (flash_simple.cu): the k-tile walk of the forward
    # and dq, dq's delta, dk/dv's q-tile walk, and the mask all three share
    "simple_fwd_skips_last_k_tile": (
        "flash_simple.cu", "for (; kb < a.Lk / T::kBK; ++kb)",
        "for (; kb < a.Lk / T::kBK - 1; ++kb)"),
    # the forward's stream: each step reads the stage after the one its
    # chunk was copied into (the next chunk, in flight or landed)
    "simple_fwd_stage_one_off": (
        "flash_simple.cu", "const float* st = ring + slot * T::kStage;",
        "const float* st = ring + (slot + 1) % kS * T::kStage;"),
    "simple_dq_ds_without_delta": (
        "flash_simple.cu", "dlt = ld4(rows + kBT + 4 * ty);",
        "dlt = make_float4(0.f, 0.f, 0.f, 0.f);"),
    # the backward's streams: dq's second pass over K reads K's last
    # chunk (still in its stage) for every column chunk of dQ, and dk/dv's
    # dV product takes Q's chunks where it streams dO's again
    "simple_dq_second_k_pass_stale_stage": (
        "flash_simple.cu", "rows_product(dq[n], dst, step(), ty, tx);",
        "rows_product(dq[n], dst, (step(), ks), ty, tx);"),
    "simple_dkv_dv_fed_q_chunks": (
        "flash_simple.cu", "(pc / kC % 2 ? gg : qg)",
        "(pc / kC == 1 ? gg : qg)"),
    # the forward's P.V reads the V tile of the ring's next stage
    "fwd_v_from_next_stage": (
        "flash_fwd.cu", "fwd_pv<D>(o, pa, ks + kBK * D);",
        "fwd_pv<D>(o, pa, kv + (s + 1) % kS * 2 * kBK * D + kBK * D);"),
    # the split dk/dv kernel of head_dim 256: its walk, dS without delta,
    # and warpgroup B's delta read from the other stage's rows
    "dkv_split_skips_last_q_tile": (
        "flash_bwd_dkv_split.cu", "for (; qb < a.Lq / T::kBQ; ++qb)",
        "for (; qb < a.Lq / T::kBQ - 1; ++qb)"),
    "dkv_split_ds_without_delta": (
        "flash_bwd_dkv_split.cu",
        "const float dsc[2] = {del.x * a.scale, del.y * a.scale};",
        "const float dsc[2] = {0.f, 0.f};"),
    "dkv_split_delta_of_other_stage": (
        "flash_bwd_dkv_split.cu",
        "split_ds<kBQ>(a, rs + kBQ, pt, tid, t, st);",
        "split_ds<kBQ>(a, rows + (s ^ 1) * 3 * kBQ + kBQ, pt, tid, t, st);"),
    "simple_dkv_skips_last_q_tile": (
        "flash_simple.cu", "for (; qb < a.Lq / kBT; ++qb)",
        "for (; qb < a.Lq / kBT - 1; ++qb)"),
    "simple_window_one_key_wider": (
        "flash_simple.cu", "(a.window <= 0 || d < a.window)",
        "(a.window <= 0 || d <= a.window)"),
    # the f32 instantiations read every operand rounded to TF32 (10
    # mantissa bits, to nearest), as a TF32 product would take it
    "simple_f32_operands_in_tf32": (
        "flash_simple.cu",
        "__device__ __forceinline__ float to_f<float>(float x) {\n"
        "  return x;\n",
        "__device__ __forceinline__ float to_f<float>(float x) {\n"
        "  return __uint_as_float((__float_as_uint(x) + 0x1000u) & "
        "0xffffe000u);\n"),
}
# faults that must fail in the cases of one (dtype, head_dim): those that
# reach the head_dim 256 wgmma kernels, and the f32 kernels' stream faults
# at 256 (four stages there, two at 64; the backward's second passes
# stream chunks only where a tile has more than one), with the f32
# backward's delta and walk faults
MUST_CATCH = {
    **dict.fromkeys(
        ("fwd_skips_last_k_tile", "fwd_v_from_next_stage",
         "dq_skips_last_k_tile", "dq_ds_without_delta",
         "dkv_split_skips_last_q_tile", "dkv_split_ds_without_delta",
         "dkv_split_delta_of_other_stage"), "bfloat16/256"),
    **dict.fromkeys(
        ("simple_fwd_stage_one_off", "simple_dq_ds_without_delta",
         "simple_dq_second_k_pass_stale_stage", "simple_dkv_skips_last_q_tile",
         "simple_dkv_dv_fed_q_chunks"), "float32/256")}
# (dtype, head_dim) -> (batch, length, q heads, kv heads) of the cases:
# the main path's shape for bf16 at 64, smaller ones elsewhere (the SIMT
# kernels and the plain versions at 64-row tiles are slow at full size)
SHAPES = {
    (torch.bfloat16, 64): (B, L, H, HKV),
    (torch.float16, 64): (2, 1024, 8, 2),
    (torch.float32, 64): (2, 1024, 8, 2),
    (torch.float32, 256): (2, 1024, 4, 2),
    (torch.bfloat16, 256): (2, 1024, 4, 2),
}


# each dtype's per-row limits, by output (kernel_check.row_tol)
LIMITS = {str(dtype).removeprefix("torch."): {
    o: kernel_check.row_tol(dtype, o) for o in ("out", "dq", "dk", "dv")}
    for dtype in (torch.bfloat16, torch.float16, torch.float32)}


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
    """{case: (args, kwargs)}: causal, window 512 and segments at each
    (dtype, head_dim) of SHAPES."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for (dtype, d), (b, l, h, hkv) in SHAPES.items():
        def randn(*shape, dtype=dtype):
            return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

        q, dout = randn(b, l, h, d), randn(b, l, h, d)
        k, v = randn(b, l, hkv, d), randn(b, l, hkv, d)
        cuts = torch.rand(b, l, device="cuda", generator=gen) < 4.0 / l
        seg = torch.cumsum(cuts.int(), dim=1).to(torch.int32).contiguous()
        args = (q, k, v, dout)
        tag = f"{str(dtype).removeprefix('torch.')}/{d}"
        out.update({f"{tag} causal": (args, dict(window=0)),
                    f"{tag} window": (args, dict(window=512)),
                    f"{tag} segments": ((*args, seg, seg), dict(window=0))})
    return out


def run_cases(data) -> dict:
    """{case: {"failures": [...], "old_check_fails": bool,
    "max_row_err": {output: err}, "lse_max_abs_err": err}}"""
    report = {}
    for case, (args, kw) in data.items():
        errs = kernel_check.flash_errors(
            *args, scale=args[0].shape[-1] ** -0.5, causal=True, **kw)
        old = [n for n, e in errs.items() if n != "lse" and
               e["max_abs_err"] > OLD_TOL * max(1.0, e["max_abs_ref"])]
        report[case] = {"failures": kernel_check.failures(errs,
                                                          args[0].dtype),
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
        caught = any(r["failures"] for case, r in rep.items()
                     if case.startswith(MUST_CATCH.get(name, "")))
        old = any(r["old_check_fails"] for r in rep.values())
        want = name != "clean"
        ok &= caught == want
        worst = max(max(r["max_row_err"].values()) for r in rep.values())
        # the outputs that miss their limit in some case, so a fault in
        # shared code shows which kernels it reaches
        missed = sorted({f"{case.split()[0]} {f.split(':')[0]}"
                         for case, r in rep.items() for f in r["failures"]})
        print(f"{name}: {'FAILS' if caught else 'passes'} the check "
              f"{'in ' + ', '.join(missed) + ' ' if missed else ''}"
              f"(worst row err {worst:.4g}, limits {LIMITS}); "
              f"the max-scaled check {'fails' if old else 'passes'} it"
              f"{'' if caught == want else '  <-- WRONG'}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "row_tol": LIMITS,
                      "results": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
