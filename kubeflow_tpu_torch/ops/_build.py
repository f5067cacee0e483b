"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source compiles with `nvcc` for sm_90a into a shared
library with a plain C interface, loaded through ctypes. The builds run
in parallel, one `nvcc` per source, on first use on a CUDA device. A
library's file name carries the hash of its sources and flags, so an
edited source rebuilds and an unchanged one is loaded as built. Build
outputs go to `kubeflow_tpu_torch/_build/` (git-ignored).

Nothing here runs at import time: the CPU tests import every module on
a machine with no `nvcc`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_bwd_dkv.cu",
           "flash_bwd_dkv_split.cu", "flash_simple.cu")
HEADERS = ("flash_sm90.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the launchers (see the extern "C" blocks in csrc/):
# pointers, then B, H, Hkv, Lq, Lk, D and the element code, then scale,
# causal, window and the stream
_FWD = [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P]
_DQ = [_P] * 9 + [_I] * 7 + [_F, _I, _I, _P]
_DKV = [_P] * 10 + [_I] * 7 + [_F, _I, _I, _P]
SIGNATURES = {
    "kft_flash_fwd": _FWD, "kft_flash_bwd_dq": _DQ, "kft_flash_bwd_dkv": _DKV,
    "kft_flash_bwd_dkv_split": _DKV,
    "kft_flash_simple_fwd": _FWD, "kft_flash_simple_bwd_dq": _DQ,
    "kft_flash_simple_bwd_dkv": _DKV,
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[1] / "_build"


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels build from source on first use")


def _lib_path(src: str, csrc: Path, out: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (src, *HEADERS):
        h.update((csrc / name).read_bytes())
    return out / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC, out: Path | None = None) -> dict[str, Path]:
    """Compile every source of `csrc` whose library is missing, all at
    once; return the library paths by source. Raises with the compiler's
    output when a build fails. The compiler log (register and spill
    counts from -Xptxas -v) lands beside each library as `<name>.log`."""
    out = out or build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {src: _lib_path(src, csrc, out) for src in SOURCES}
    todo = {src: p for src, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for src, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, p)
    failed = []
    for src, (proc, tmp, p) in procs.items():
        log, _ = proc.communicate()
        p.with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"{src}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, p)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


# the element types as their C++ names mangle
_MANGLED = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}


def ptxas_report(paths: dict[str, Path]) -> dict[str, dict[tuple, dict]]:
    """Registers and spill bytes of each kernel, by kernel name (the
    `__global__` function's name without `_kernel`) and (element type,
    head dim), e.g. ("bf16", 64), from the `-Xptxas -v` logs of `build`.
    Registers are ptxas's count at launch; a kernel that moves registers
    between warpgroups with setmaxnreg runs its consumers above it."""
    report: dict[str, dict[tuple, dict]] = {}
    for p in paths.values():
        entry = None
        for line in p.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '\S*?(flash_\w+?)_kernel"
                          r"ILi(\d+)E(13__nv_bfloat16|6__half|f)E", line)
            if m:
                key = (_MANGLED[m.group(3)], int(m.group(2)))
                entry = report.setdefault(m.group(1), {}).setdefault(key, {})
            elif entry is not None:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    entry["registers"] = int(m.group(1))
    return report


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
    if hasattr(lib, "kft_error_string"):
        lib.kft_error_string.argtypes = [_I]
        lib.kft_error_string.restype = ctypes.c_char_p
    return lib


def library(src: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if need be."""
    with _lock:
        if src not in _libs:
            _libs.update({name: _load(p) for name, p in build().items()})
        return _libs[src]


@contextlib.contextmanager
def using(paths: dict[str, Path]):
    """Route the kernel wrappers to other builds of the sources (those
    of `build(csrc=...)` on an altered copy) until the block exits."""
    with _lock:
        saved = dict(_libs)
        _libs.update({name: _load(p) for name, p in paths.items()})
    try:
        yield
    finally:
        with _lock:
            _libs.clear()
            _libs.update(saved)


def check(err: int, what: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if err:
        msg = library("flash_fwd.cu").kft_error_string(err)
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({msg.decode(errors='replace')})")
