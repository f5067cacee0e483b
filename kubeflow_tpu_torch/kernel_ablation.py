"""Where a flash kernel's time goes: ablated builds, timed on the card.

    python -m kubeflow_tpu_torch.kernel_ablation

Builds altered copies of the CUDA sources under `_build/ablations/`, as
`mutation_check` builds its faults (one text substitution each, which
must match once), each leaving one part of a kernel out, and times that
kernel in every build at the llama-1b attention shapes of chip_smoke.py's
kernel phase (q [8, 2048, 32, 64], k/v 8 heads, bf16, causal), with
`kernel_check.device_ms`. An ablated kernel computes a wrong result:
only its time is read. Each ablated build is timed between two timings
of the unaltered build; a part's cost is their mean less the ablated
time: what the part adds to the kernel's time, after whatever the rest
of the kernel hides of it. Prints one line per ablation and a JSON
record. Needs one CUDA GPU and `nvcc`.
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from kubeflow_tpu_torch.mutation_check import plant
from kubeflow_tpu_torch.ops import _build, kernel_check
from kubeflow_tpu_torch.ops import flash_attention as fa

B, L, H, HKV, D = 8, 2048, 32, 8, 64

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
}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: needs a CUDA GPU")
    with ThreadPoolExecutor(len(ABLATIONS) + 1) as pool:
        clean = pool.submit(_build.build)
        built = {n: pool.submit(plant, n, edit, "ablations")
                 for n, (_, edit) in ABLATIONS.items()}
        builds = {"clean": clean.result()}
        builds.update({n: f.result() for n, f in built.items()})
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    q, dout = randn(B, L, H, D), randn(B, L, H, D)
    k, v = randn(B, L, HKV, D), randn(B, L, HKV, D)
    cfg = dict(scale=D ** -0.5, causal=True)
    out, lse = fa.flash_fwd_cuda(q, k, v, **cfg)
    delta = fa.flash_delta(out, dout)
    run = {"flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, **cfg),
           "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(
               q, k, v, dout, lse, delta, **cfg),
           "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(
               q, k, v, dout, lse, delta, **cfg)}

    def timed(paths, kernel: str) -> float:
        with _build.using(paths):
            return kernel_check.device_ms(run[kernel])

    # each ablated build between two timings of the unaltered one, so a
    # card that speeds up or slows down during the run shows in the
    # bracket instead of in the part's cost
    report = {}
    for n, (kernel, _) in ABLATIONS.items():
        before = timed(builds["clean"], kernel)
        ablated = timed(builds[n], kernel)
        after = timed(builds["clean"], kernel)
        cost = (before + after) / 2 - ablated
        report[n] = {"kernel": kernel, "clean_ms": [before, after],
                     "ablated_ms": ablated, "cost_ms": cost}
        print(f"{n}: {kernel} {ablated:.4f} ms, unaltered {before:.4f} / "
              f"{after:.4f} ms, the part costs {cost:+.4f} ms", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ablations": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
