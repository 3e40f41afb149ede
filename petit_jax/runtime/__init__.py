"""Native runtime components (C++ via ctypes).

The reference implements its offline repack path in native code
(quantization_utils.cu); here the equivalent is a host-side C++ core
compiled on first use. ops/layout.py transparently uses it when
available and falls back to numpy (bit-identical; tests cover both).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "repack.cpp")
_SO = os.path.join(_DIR, "libpetit_runtime.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", _SO, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native runtime; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (os.path.getmtime(_SO)
                                       < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.petit_repack_fp4.restype = ctypes.c_int
        lib.petit_repack_fp4.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.petit_process_scales.restype = ctypes.c_int
        lib.petit_process_scales.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int]
        _lib = lib
        return _lib


def repack_fp4_native(qw: np.ndarray, n: int, k: int):
    """uint8 (n, k/2) -> uint32 (k/8, n), or None if native lib unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    qw = np.ascontiguousarray(qw, dtype=np.uint8)
    out = np.empty((k // 8, n), dtype=np.uint32)
    rc = lib.petit_repack_fp4(
        qw.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n), ctypes.c_int64(k))
    if rc != 0:
        raise ValueError(f"native repack rejected shape n={n} k={k}")
    return out


def process_scales_native(scales: np.ndarray, n: int, groups: int,
                          group: int = 16):
    """Raw E4M3/E8M0 (n, groups) u8 -> bf16 stride-16 rows (groups, n) for
    E4M3 / (2*groups, n) for E8M0 (duplicated per half-group), or None if
    the native lib is unavailable. Returned dtype is ml_dtypes.bfloat16."""
    import ml_dtypes
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(scales, dtype=np.uint8)
    out = np.empty((groups * (2 if group == 32 else 1), n), dtype=np.uint16)
    rc = lib.petit_process_scales(
        s.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n), ctypes.c_int64(groups), ctypes.c_int(group))
    if rc != 0:
        raise ValueError("native scale decode/transpose failed")
    return out.view(ml_dtypes.bfloat16)
