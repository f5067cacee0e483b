"""Where a flash kernel's time goes: ablated builds, timed on the card.

    python -m kubeflow_tpu_torch.kernel_ablation [--head-dim 256]
        [--dtype float32]

Builds altered copies of the CUDA sources under `_build/ablations/`, as
`mutation_check` builds its faults (one text substitution each, which
must match once), each leaving one part of a kernel out, and times that
kernel in every build at the llama-1b attention shapes of chip_smoke.py's
kernel phase (q [8, 2048, 32, 64], k/v 8 heads, bf16, causal; with
`--head-dim 256`, [8, 2048, 8, 256] with 2 kv heads, where the forward,
dq and the split dk/dv run: the ablations of the forward and dq; with
`--dtype float32`, the SIMT kernels of flash_simple.cu at that shape:
the ablations of their dq and dk/dv), with `kernel_check.device_ms`. An
ablated kernel computes a wrong result: only its time is read. Each
ablated build is timed between two timings of the unaltered build; a
part's cost is their mean less the ablated time: what the part adds to
the kernel's time, after whatever the rest of the kernel hides of it.
Prints one line per ablation and a JSON record. Needs one CUDA GPU and
`nvcc`.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from kubeflow_tpu_torch.mutation_check import plant
from kubeflow_tpu_torch.ops import _build, kernel_check
from kubeflow_tpu_torch.ops import flash_attention as fa

# head_dim -> (batch, length, q heads, kv heads): the kernel phase's
SHAPES = {64: (8, 2048, 32, 8), 128: (8, 2048, 16, 4), 256: (8, 2048, 8, 2)}

# name -> (kernel, (file, text, replacement)); `if constexpr (D == 0)`
# drops a statement at compile time, and a store under an impossible
# window keeps the values it would write alive
ABLATIONS = {
    "fwd_no_qk_product": ("flash_fwd", (
        "flash_fwd.cu", "        wgmma_ss<kBK, E>(sc, desc_k(",
        "        if constexpr (D == 0) wgmma_ss<kBK, E>(sc, desc_k(")),
    "fwd_no_pv_product": ("flash_fwd", (
        "flash_fwd.cu", "      fwd_pv<D>(o, pa, ks + kBK * D);",
        "      if constexpr (D == 0) fwd_pv<D>(o, pa, ks + kBK * D);")),
    "fwd_no_exp_interior": ("flash_fwd", (
        "flash_fwd.cu", "sc[e] = ex2(fmaf(sc[e], scale2, -m[r]));",
        "sc[e] = fmaf(sc[e], scale2, -m[r]);")),
    "fwd_no_mask": ("flash_fwd", (
        "flash_fwd.cu",
        "if (tile_interior(a, r_lo, r_lo + 63, k0, k0 + kBK - 1, offset)) {",
        "if (true) {")),
    "fwd_no_store": ("flash_fwd", (
        "flash_fwd.cu",
        "    for (int r = 0; r < 2; ++r) {\n"
        "      const float li = fmaxf(quad_sum(l[r]), 1e-20f);",
        "    for (int r = 0; r < 2 * (a.window < 0); ++r) {\n"
        "      const float li = fmaxf(quad_sum(l[r]), 1e-20f);")),
    "dkv_no_st_product": ("flash_bwd_dkv", (
        "flash_bwd_dkv.cu", "      wgmma_ss_n64<E>(st, desc_k(",
        "      if constexpr (D == 0) wgmma_ss_n64<E>(st, desc_k(")),
    "dkv_no_grad_products": ("flash_bwd_dkv", (
        "flash_bwd_dkv.cu", "    dkv_grads<D>(dk, dv, pt, dst, qt);",
        "    if constexpr (D == 0) dkv_grads<D>(dk, dv, pt, dst, qt);")),
    "dkv_no_exp_interior": ("flash_bwd_dkv", (
        "flash_bwd_dkv.cu", "x = ex2(fmaf(x, scale2, -lse2[e & 1]));",
        "x = fmaf(x, scale2, -lse2[e & 1]);")),
    "dq_no_s_product": ("flash_bwd_dq", (
        "flash_bwd.cu", "        wgmma_ss<kBK, E>(s, desc_k(",
        "        if constexpr (D == 0) wgmma_ss<kBK, E>(s, desc_k(")),
    "dq_no_dp_product": ("flash_bwd_dq", (
        "flash_bwd.cu", "        wgmma_ss<kBK, E>(dp, desc_k(",
        "        if constexpr (D == 0) wgmma_ss<kBK, E>(dp, desc_k(")),
    "dq_no_dq_product": ("flash_bwd_dq", (
        "flash_bwd.cu", "      dq_grad<D>(dq, dsa, ks);",
        "      if constexpr (D == 0) dq_grad<D>(dq, dsa, ks);")),
    "dq_no_exp_interior": ("flash_bwd_dq", (
        "flash_bwd.cu", "x = ex2(fmaf(x, scale2, -lse2[r]));",
        "x = fmaf(x, scale2, -lse2[r]);")),
    "dq_no_mask": ("flash_bwd_dq", (
        "flash_bwd.cu",
        "if (tile_interior(a, r_lo, r_lo + 63, k0, k0 + kBK - 1, offset))",
        "if (true)")),
    # the f32 SIMT backward (flash_simple.cu): its two kinds of product are
    # helpers both kernels call, so one edit ablates a kind in both and
    # each ablation times one kernel; the exp is each kernel's own
    "simple_dq_no_s_dp_products": ("flash_simple_bwd_dq", (
        "flash_simple.cu", "  for (int x = 0; x < 64; x += 4) {",
        "  for (int x = 0; x < 0; x += 4) {")),
    "simple_dq_no_dq_product": ("flash_simple_bwd_dq", (
        "flash_simple.cu", "  for (int y = 0; y < kBT; ++y) {",
        "  for (int y = 0; y < 0; ++y) {")),
    "simple_dq_no_exp": ("flash_simple_bwd_dq", (
        "flash_simple.cu",
        "s[i][j] = ex2(x) * (dp[i][j] - at(dlt, i)) * a.scale;",
        "s[i][j] = x * (dp[i][j] - at(dlt, i)) * a.scale;")),
    "simple_dkv_no_st_dpt_products": ("flash_simple_bwd_dkv", (
        "flash_simple.cu", "  for (int x = 0; x < 64; x += 4) {",
        "  for (int x = 0; x < 0; x += 4) {")),
    "simple_dkv_no_dv_dk_products": ("flash_simple_bwd_dkv", (
        "flash_simple.cu", "  for (int y = 0; y < kBT; ++y) {",
        "  for (int y = 0; y < 0; ++y) {")),
    "simple_dkv_no_exp": ("flash_simple_bwd_dkv", (
        "flash_simple.cu", "st[i][c] = ex2(x);", "st[i][c] = x;")),
}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(prog="kernel_ablation")
    parser.add_argument("--head-dim", type=int, default=64,
                        choices=sorted(SHAPES))
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: needs a CUDA GPU")
    d = args.head_dim
    b, l, h, hkv = SHAPES[d]
    dtype = getattr(torch, args.dtype)
    # the ablations of the kernels that take this dtype at this head dim
    names = fa.kernels_for(dtype, d)
    ablations = {n: (kernel, edit) for n, (kernel, edit) in ABLATIONS.items()
                 if kernel in names}
    with ThreadPoolExecutor(len(ablations) + 1) as pool:
        clean = pool.submit(_build.build)
        built = {n: pool.submit(plant, n, edit, "ablations")
                 for n, (_, edit) in ablations.items()}
        builds = {"clean": clean.result()}
        builds.update({n: f.result() for n, f in built.items()})
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    q, dout = randn(b, l, h, d), randn(b, l, h, d)
    k, v = randn(b, l, hkv, d), randn(b, l, hkv, d)
    cfg = dict(scale=d ** -0.5, causal=True)
    out, lse = fa.flash_fwd_cuda(q, k, v, **cfg)
    delta = fa.flash_delta(out, dout)
    fwd, dq_name, dkv = names
    run = {fwd: lambda: fa.flash_fwd_cuda(q, k, v, **cfg),
           dq_name: lambda: fa.flash_bwd_dq_cuda(
               q, k, v, dout, lse, delta, **cfg),
           dkv: lambda: fa.flash_bwd_dkv_cuda(
               q, k, v, dout, lse, delta, **cfg)}

    # the SIMT kernels take milliseconds a launch: fewer launches a timing
    reps = dict(n=5, reps=3) if dtype == torch.float32 else {}

    def timed(paths, kernel: str) -> float:
        with _build.using(paths):
            return kernel_check.device_ms(run[kernel], **reps)

    # each ablated build between two timings of the unaltered one, so a
    # card that speeds up or slows down during the run shows in the
    # bracket instead of in the part's cost
    report = {}
    for n, (kernel, _) in ablations.items():
        before = timed(builds["clean"], kernel)
        ablated = timed(builds[n], kernel)
        after = timed(builds["clean"], kernel)
        cost = (before + after) / 2 - ablated
        report[n] = {"kernel": kernel, "clean_ms": [before, after],
                     "ablated_ms": ablated, "cost_ms": cost}
        print(f"{n}: {kernel} {ablated:.4f} ms, unaltered {before:.4f} / "
              f"{after:.4f} ms, the part costs {cost:+.4f} ms", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "dtype": args.dtype,
                      "shape": [b, l, h, d], "kv_heads": hkv,
                      "ablations": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
