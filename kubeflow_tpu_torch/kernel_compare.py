"""Two builds of the flash kernels on one card: equal bit for bit, and
their times in turns.

    python -m kubeflow_tpu_torch.kernel_compare TREE

TREE is another checkout of the repository (a parent commit's `git
archive`, unpacked). Builds its `kubeflow_tpu_torch/ops/csrc` into
`_build/compare/` beside this checkout's own build, then, with the
wrappers routed to each build in turn (`_build.using`):

1. `SAME`: the kernels both builds share run on the same card tensors
   (the kernel phase's shapes, causal, window 512, segment ids); every
   output they write (out and lse; dq, dk and dv where the backward
   kernels are shared too) must be equal bit for bit.
2. `TIMED`: each kernel this change redesigned, in the other build and
   in this one, at the kernel phase's shapes, causal: `kernel_check.
   device_ms` in the order other, this, this, other, so a card that
   drifts shows in the spread.

Prints one line per check and a JSON record; exits non-zero when an
output differs. Needs one CUDA GPU and `nvcc`.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

import torch

from kubeflow_tpu_torch.ops import _build, kernel_check
from kubeflow_tpu_torch.ops import flash_attention as fa

# (dtype, head_dim) -> (batch, length, q heads, kv heads): the kernel
# phase's shapes (chip_smoke.py KERNEL_SHAPES)
SHAPES = {64: (8, 2048, 32, 8), 128: (8, 2048, 16, 4), 256: (8, 2048, 8, 2)}
# (dtype, head_dim) -> the kernels (by role) both builds must compute bit
# for bit alike: every wgmma kernel, and the f32 SIMT forward
SAME = {
    **{(dtype, d): ("fwd", "dq", "dkv")
       for dtype in (torch.bfloat16, torch.float16) for d in (64, 128, 256)},
    **{(torch.float32, d): ("fwd",) for d in (64, 128, 256)},
}
# label -> (kernel in the other build, kernel in this one, dtype, head_dim):
# the f32 SIMT backward kernels
TIMED = {f"{role} float32/{d}": (name, name, torch.float32, d)
         for d in (64, 128, 256)
         for role, name in (("dq", "flash_simple_bwd_dq"),
                            ("dkv", "flash_simple_bwd_dkv"))}


def _inputs(dtype, d, seed=0):
    b, l, h, hkv = SHAPES[d]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    q, dout = randn(b, l, h, d), randn(b, l, h, d)
    k, v = randn(b, l, hkv, d), randn(b, l, hkv, d)
    cuts = torch.rand(b, l, device="cuda", generator=gen) < 4.0 / l
    seg = torch.cumsum(cuts.int(), dim=1).to(torch.int32).contiguous()
    return q, k, v, dout, seg


def _call(name: str, q, k, v, dout, lse, delta, qseg=None, kseg=None, *,
          window=0):
    """Kernel `name` (whichever build the wrappers are routed to) on the
    given tensors: its outputs."""
    cfg = (float(q.shape[-1] ** -0.5), 1, int(window))
    dims = fa._dims(q, k)
    ptr = fa._ptr
    if name.endswith("_fwd"):
        b, lq, h, _ = q.shape
        out = torch.empty_like(q)
        lse_out = torch.empty((b, h, lq), dtype=torch.float32,
                              device=q.device)
        fa._launch(name, q, ptr(q), ptr(k), ptr(v), ptr(qseg), ptr(kseg),
                   ptr(out), ptr(lse_out), *dims, *cfg)
        return out, lse_out
    args = fa._bwd_args(q, k, v, dout, lse, delta, qseg, kseg)
    if "dq" in name:
        dq = torch.empty_like(q)
        fa._launch(name, q, *args, ptr(dq), *dims, *cfg)
        return (dq,)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fa._launch(name, q, *args, ptr(dk), ptr(dv), *dims, *cfg)
    return dk, dv


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_compare: needs a CUDA GPU")
    if len(argv) != 1:
        raise SystemExit(__doc__)
    other_csrc = Path(argv[0]).resolve() / "kubeflow_tpu_torch/ops/csrc"
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {"this": _build.build(),
              "other": _build.build(csrc=other_csrc,
                                    out=_build.build_dir() / "compare")}
    card = torch.cuda.get_device_name(0)
    report = {"same": {}, "timed": {}}
    ok = True
    for (dtype, d), roles in SAME.items():
        q, k, v, dout, seg = _inputs(dtype, d)
        fwd, dq_name, dkv = fa.kernels_for(dtype, d)
        for tag, segs, window in (("causal", (), 0), ("window", (), 512),
                                  ("segments", (seg, seg), 0)):
            outs = {}
            for which, paths in builds.items():
                with _build.using(paths):
                    out, lse = _call(fwd, q, k, v, None, None, None, *segs,
                                     window=window)
                    got = {"out": out, "lse": lse}
                    delta = fa.flash_delta(out, dout)
                    if "dq" in roles:
                        got["dq"], = _call(dq_name, q, k, v, dout, lse,
                                           delta, *segs, window=window)
                    if "dkv" in roles:
                        got["dk"], got["dv"] = _call(
                            dkv, q, k, v, dout, lse, delta, *segs,
                            window=window)
                    torch.cuda.synchronize()
                    outs[which] = got
            equal = {n: bool(torch.equal(x, outs["other"][n]))
                     for n, x in outs["this"].items()}
            case = f"{str(dtype)[6:]}/{d} {tag}"
            report["same"][case] = equal
            ok &= all(equal.values())
            print(f"same {case}: {equal}", flush=True)
        del q, k, v, dout, seg
    for label, (old, new, dtype, d) in TIMED.items():
        q, k, v, dout, _ = _inputs(dtype, d)
        out, lse = fa.flash_fwd_plain(q, k, v, scale=d ** -0.5, causal=True,
                                      **fa.kernel_blocks(
                                          fa.kernels_for(dtype, d)[0], d))
        delta = fa.flash_delta(out, dout)
        slow = dtype == torch.float32 or old.startswith("flash_simple")
        reps = dict(n=5, reps=3) if slow else {}
        ms = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            name = old if which == "other" else new
            with _build.using(builds[which]):
                ms[which].append(kernel_check.device_ms(
                    lambda: _call(name, q, k, v, dout, lse, delta), **reps))
        report["timed"][label] = {"other": [old, ms["other"]],
                                  "this": [new, ms["this"]]}
        print(f"timed {label}: other build's {old} {ms['other']} ms, this "
              f"build's {new} {ms['this']} ms (means "
              f"{statistics.mean(ms['other']):.3f} / "
              f"{statistics.mean(ms['this']):.3f})", flush=True)
        del q, k, v, dout, out, lse, delta
    print(json.dumps({"device": card, "ok": ok, **report}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
