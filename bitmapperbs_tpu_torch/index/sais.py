"""Suffix-array construction.

Reference parity: BitMapperBS vendors pSAscan / libdivsufsort (native C/C++,
SURVEY.md C4).  Our native equivalent is a C++ SA-IS shared library
(`sais_native/sais.cpp`) loaded via ctypes; `suffix_array_numpy` is the
pure-numpy prefix-doubling fallback used when the extension is not built and
as an independent oracle in tests.

Input convention: `text` is a uint8/int array whose LAST element is a unique
smallest sentinel (0) not occurring elsewhere.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_TRIED = False


def _native_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = os.path.join(os.path.dirname(__file__), "sais_native", "libsais.so")
    if os.path.exists(path):
        lib = ctypes.CDLL(path)
        lib.sais_u8_i64.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.sais_u8_i64.restype = ctypes.c_int
        if hasattr(lib, "bwtinc_build"):
            lib.bwtinc_build.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.bwtinc_build.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def bwt_via_insertion(text: np.ndarray, sa_rate: int):
    """Bounded-RAM BWT + SA-sample construction (native dynamic-BWT).

    Never materializes a suffix array (SURVEY.md C4 external-memory role:
    ~0.5 B/char of working memory in the C++ tree vs ~12 B/char for SA-IS).
    Returns (bwt_packed uint8[ceil(n/4) padded to 64], mark_bits
    uint8[ceil(n/8)], samples uint32[nmarks]) for `text` with its unique
    smallest sentinel (0) last.
    """
    lib = _native_lib()
    if lib is None or not hasattr(lib, "bwtinc_build"):
        raise RuntimeError(
            "native libsais.so with bwtinc_build not built "
            "(make -C bitmapperbs_tpu_torch/index/sais_native)")
    t = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(t)
    packed = np.zeros((n // 4 + 64) & ~63, dtype=np.uint8)
    marks = np.zeros((n + 7) // 8, dtype=np.uint8)
    samples = np.zeros(n // sa_rate + 2, dtype=np.uint32)
    nm = ctypes.c_int64(0)
    rc = lib.bwtinc_build(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n), ctypes.c_int32(sa_rate),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        marks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(nm))
    if rc != 0:
        raise RuntimeError(f"bwtinc_build failed with rc={rc}")
    return packed, marks, samples[:nm.value].copy()


def suffix_array_numpy(text: np.ndarray) -> np.ndarray:
    """O(n log^2 n) prefix-doubling SA via np.lexsort. Returns int64."""
    t = np.ascontiguousarray(text, dtype=np.int64)
    n = len(t)
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    rank = t
    k = 1
    while True:
        key2 = np.zeros(n, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1, r2 = rank[order], key2[order]
        bump = np.empty(n, dtype=np.int64)
        bump[0] = 0
        bump[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[order] = np.cumsum(bump)
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order.astype(np.int64)
        k *= 2


def suffix_array(text: np.ndarray) -> np.ndarray:
    """SA of `text` (unique smallest sentinel last). Prefers the native SA-IS."""
    t = np.ascontiguousarray(text, dtype=np.uint8)
    lib = _native_lib()
    if lib is not None:
        n = len(t)
        sa = np.empty(n, dtype=np.int64)
        rc = lib.sais_u8_i64(
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n),
        )
        if rc != 0:
            raise RuntimeError(f"native sais failed with rc={rc}")
        return sa
    return suffix_array_numpy(t)
