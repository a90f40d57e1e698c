"""ctypes bindings for the native C++ runtime layer (native/gct_native.cpp).

Block-quant encode/decode in multithreaded C++, bit-identical to the NumPy
oracle (enforced by tests/test_native.py). The shared library is built from
``native/*.cpp`` with ``make -C native`` at first use; the codec falls back
to the NumPy oracle only when no C++ compiler is present.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

from ggml_cuda_experiments_tpu.oracle import quant as quant_ref

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libgct_native.so"

_i64 = ctypes.c_int64
_int = ctypes.c_int
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _stale() -> bool:
    src = max(p.stat().st_mtime for p in _NATIVE_DIR.glob("*.cpp"))
    return not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < src


def lib_path() -> Path | None:
    """Path of the built library, building it first if it is missing or
    older than its sources. Concurrent callers (test workers) serialize on
    a lock file; the build writes a temporary name and renames it, so no
    process ever loads a half-written library. None when the build fails
    (no compiler)."""
    if not _stale():
        return _LIB_PATH
    with open(_NATIVE_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            tmp = f"{_LIB_PATH.name}.partial"
            r = subprocess.run(["make", "-s", "-C", str(_NATIVE_DIR),
                                f"LIB={tmp}"], capture_output=True)
            if r.returncode != 0:
                return None
            os.replace(_NATIVE_DIR / tmp, _LIB_PATH)
    return _LIB_PATH


@functools.cache
def _lib():
    path = lib_path()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.gct_version.restype = ctypes.c_int
    lib.gct_quantize_q8_0.argtypes = [_f32p, _i8p, _f32p, _i64, _i64, _int]
    lib.gct_quantize_q4_0.argtypes = [_f32p, _u8p, _f32p, _i64, _i64, _int]
    lib.gct_quantize_q4_k.argtypes = [_f32p, _u8p, _u8p, _u8p, _f32p, _f32p,
                                      _i64, _i64, _int]
    lib.gct_dequantize_q8_0.argtypes = [_i8p, _f32p, _f32p, _i64, _i64, _int]
    lib.gct_dequantize_q4_0.argtypes = [_u8p, _f32p, _f32p, _i64, _i64, _int]
    lib.gct_dequantize_q4_k.argtypes = [_u8p, _u8p, _u8p, _f32p, _f32p,
                                        _f32p, _i64, _i64, _int]
    if hasattr(lib, "gct_quantize_q6_k"):   # older prebuilt .so may lack it
        lib.gct_quantize_q6_k.argtypes = [_f32p, _u8p, _i8p, _f32p,
                                          _i64, _i64, _int]
        lib.gct_dequantize_q6_k.argtypes = [_u8p, _i8p, _f32p, _f32p,
                                            _i64, _i64, _int]
    return lib


def available() -> bool:
    return _lib() is not None


_NTHREADS = max(1, os.cpu_count() or 1)


def _as2d(x: np.ndarray) -> tuple[np.ndarray, tuple]:
    x = np.ascontiguousarray(x, np.float32)
    shape = x.shape
    return x.reshape(-1, shape[-1]), shape


def quantize(x: np.ndarray, fmt: str):
    """Quantize with the native codec (oracle layout/semantics); falls back
    to the NumPy oracle if the library is missing."""
    lib = _lib()
    if lib is None:
        return quant_ref.FORMATS[fmt][0](x)
    x2, shape = _as2d(x)
    n, k = x2.shape
    if fmt == "q8_0":
        qs = np.empty((n, k), np.int8)
        d = np.empty((n, k // 32), np.float32)
        lib.gct_quantize_q8_0(x2, qs, d, n, k, _NTHREADS)
        return quant_ref.Q8_0(qs=qs.reshape(shape),
                              d=d.reshape(*shape[:-1], k // 32), shape=shape)
    if fmt == "q4_0":
        qs = np.empty((n, k // 2), np.uint8)
        d = np.empty((n, k // 32), np.float32)
        lib.gct_quantize_q4_0(x2, qs, d, n, k, _NTHREADS)
        return quant_ref.Q4_0(qs=qs.reshape(*shape[:-1], k // 2),
                              d=d.reshape(*shape[:-1], k // 32), shape=shape)
    if fmt == "q4_k":
        qs = np.empty((n, k // 2), np.uint8)
        sc = np.empty((n, k // 32), np.uint8)
        mn = np.empty((n, k // 32), np.uint8)
        d = np.empty((n, k // 256), np.float32)
        dmin = np.empty((n, k // 256), np.float32)
        lib.gct_quantize_q4_k(x2, qs, sc, mn, d, dmin, n, k, _NTHREADS)
        return quant_ref.Q4_K(
            qs=qs.reshape(*shape[:-1], k // 2),
            sc=sc.reshape(*shape[:-1], k // 32),
            mn=mn.reshape(*shape[:-1], k // 32),
            d=d.reshape(*shape[:-1], k // 256),
            dmin=dmin.reshape(*shape[:-1], k // 256), shape=shape)
    if fmt == "q6_k" and hasattr(lib, "gct_quantize_q6_k"):
        qs = np.empty((n, k), np.uint8)
        sc = np.empty((n, k // 16), np.int8)
        d = np.empty((n, k // 256), np.float32)
        lib.gct_quantize_q6_k(x2, qs, sc, d, n, k, _NTHREADS)
        return quant_ref.Q6_K(
            qs=qs.reshape(shape),
            sc=sc.reshape(*shape[:-1], k // 16),
            d=d.reshape(*shape[:-1], k // 256), shape=shape)
    if fmt in quant_ref.FORMATS:         # formats without a native codec
        return quant_ref.FORMATS[fmt][0](x)
    raise ValueError(fmt)


def dequantize(t) -> np.ndarray:
    lib = _lib()
    if lib is None or (isinstance(t, quant_ref.Q6_K)
                       and not hasattr(lib, "gct_dequantize_q6_k")):
        classes = {"q8_0": quant_ref.Q8_0, "q4_0": quant_ref.Q4_0,
                   "q4_k": quant_ref.Q4_K, "q6_k": quant_ref.Q6_K}
        for fmt, (_, deq) in quant_ref.FORMATS.items():
            if isinstance(t, classes[fmt]):
                return deq(t)
        raise TypeError(type(t))
    *lead, k = t.shape
    n = int(np.prod(lead)) if lead else 1
    out = np.empty((n, k), np.float32)
    if isinstance(t, quant_ref.Q8_0):
        lib.gct_dequantize_q8_0(
            np.ascontiguousarray(t.qs).reshape(n, k),
            np.ascontiguousarray(t.d, np.float32).reshape(n, k // 32),
            out, n, k, _NTHREADS)
    elif isinstance(t, quant_ref.Q4_0):
        lib.gct_dequantize_q4_0(
            np.ascontiguousarray(t.qs).reshape(n, k // 2),
            np.ascontiguousarray(t.d, np.float32).reshape(n, k // 32),
            out, n, k, _NTHREADS)
    elif isinstance(t, quant_ref.Q4_K):
        lib.gct_dequantize_q4_k(
            np.ascontiguousarray(t.qs).reshape(n, k // 2),
            np.ascontiguousarray(t.sc).reshape(n, k // 32),
            np.ascontiguousarray(t.mn).reshape(n, k // 32),
            np.ascontiguousarray(t.d, np.float32).reshape(n, k // 256),
            np.ascontiguousarray(t.dmin, np.float32).reshape(n, k // 256),
            out, n, k, _NTHREADS)
    elif isinstance(t, quant_ref.Q6_K):
        lib.gct_dequantize_q6_k(
            np.ascontiguousarray(t.qs).reshape(n, k),
            np.ascontiguousarray(t.sc).reshape(n, k // 16),
            np.ascontiguousarray(t.d, np.float32).reshape(n, k // 256),
            out, n, k, _NTHREADS)
    else:
        raise TypeError(type(t))
    return out.reshape(t.shape)
