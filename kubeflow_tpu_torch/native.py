"""The native KFR1 record loader, built and bound with ctypes (the port's
counterpart of kubeflow_tpu/native/__init__.py).

The library is the repo's `native/kfdata.cc` (file reading, CRC checks,
the shuffle pool and batch assembly on a C++ thread). It is compiled
with `g++ -O3 -std=c++17 -fPIC -shared -pthread` into the git-ignored
`kubeflow_tpu_torch/_build/libkfdata.so` at first use, and again when
the source is newer than the library. `native/Makefile` is not used: it
writes into the JAX package. With no compiler, `load()` returns None and
runtime/records.py reads with its Python loader.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

log = logging.getLogger("kubeflow_tpu_torch.native")

SOURCE = Path(__file__).resolve().parents[1] / "native" / "kfdata.cc"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def library_path() -> Path:
    return Path(__file__).resolve().parent / "_build" / "libkfdata.so"


def build() -> Path | None:
    """The built library, compiled first when missing or older than the
    source; None when it cannot be built (no source, no g++, a compile
    error)."""
    out = library_path()
    if not SOURCE.exists():
        return out if out.exists() else None
    if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # a private temp name, then a rename: concurrent builders never load
    # a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        detail = getattr(e, "stderr", b"") or b""
        log.warning("native build failed (%s %s); using the Python loader",
                    e, detail.decode(errors="replace")[-500:])
        return out if out.exists() else None
    return out


def load() -> ctypes.CDLL | None:
    """The kfdata library with argtypes configured, or None (cached)."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = build()
        if path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("cannot dlopen %s (%s); using the Python loader",
                        path, e)
            _load_failed = True
            return None
        lib.kfdl_open.restype = ctypes.c_void_p
        lib.kfdl_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.kfdl_next.restype = ctypes.c_int64
        lib.kfdl_next.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int64]
        lib.kfdl_error.restype = ctypes.c_char_p
        lib.kfdl_error.argtypes = [ctypes.c_void_p]
        lib.kfdl_close.restype = None
        lib.kfdl_close.argtypes = [ctypes.c_void_p]
        lib.kfdl_crc32.restype = ctypes.c_uint32
        lib.kfdl_crc32.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_uint64]
        _lib = lib
        return _lib
