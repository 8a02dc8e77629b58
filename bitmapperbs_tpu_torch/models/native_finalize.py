"""ctypes binding for the native SE finalize (index/sais_native/finalize.cpp).

Reference parity: the traceback/output stage is native C in BitMapperBS
(SURVEY.md C13/C18).  models/finalize.py's numpy implementation remains the
frozen spec (itself byte-identical to the oracle finalize_hit);
`finalize_se_native` returns records field-identical to
`finalize_batch_device` (tests/test_native_finalize.py) at a fraction of the
per-record interpreter cost, or None when the shared library is not built
(numpy fallback) or BTBS_NO_NATIVE_FINALIZE is set.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.io.sam import SamRecord
# single source for the derived spec tables (kept in the numpy spec module
# so the native and numpy paths can never desynchronize)
from bitmapperbs_tpu_torch.models.finalize import _MQ_TAB, _TAG4

_LIB = None
_LIB_TRIED = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "index", "sais_native", "libsais.so")
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    if not hasattr(lib, "btbs_finalize_se"):
        return None
    lib.btbs_finalize_se.argtypes = [
        _u8p, ctypes.c_int64, _i64p, ctypes.c_int64,
        _i64p, _i64p, _i64p, _i64p,
        _u8p, ctypes.c_int64,
        _i64p, _i64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _i32p,
        _i32p, _i32p,
        _i32p, _i32p, _i32p, _i64p, _i32p, _i32p, _i32p, _i32p,
        ctypes.c_char_p, ctypes.c_int64, _i64p, _i64p,
    ]
    lib.btbs_finalize_se.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return (not os.environ.get("BTBS_NO_NATIVE_FINALIZE")
            and _lib() is not None)


def _p64(a):
    return a.ctypes.data_as(_i64p)


def finalize_se_native(idx, rc_ref, cfg, arr, lengths, quals, qnames,
                       out_np, flag_extras=None, mapq_overrides=None):
    """Native equivalent of finalize_batch_device; returns list of
    SamRecord | None per read, or None when the native library is absent
    (caller falls back to the numpy path).  flag_extras / mapq_overrides
    mirror finalize_batch's (the PE assembler's per-item FLAG bits and
    pair-level MAPQ)."""
    if not available():
        return None
    lib = _lib()
    n = len(qnames)
    fx = mq = None
    fx_p = mq_p = ctypes.cast(None, _i32p)
    if flag_extras is not None:
        fx = np.ascontiguousarray(flag_extras[:n], dtype=np.int32)
        fx_p = fx.ctypes.data_as(_i32p)
    if mapq_overrides is not None:
        mq = np.array([-1 if v is None else v
                       for v in mapq_overrides[:n]], dtype=np.int32)
        mq_p = mq.ctypes.data_as(_i32p)
    arr = np.ascontiguousarray(arr[:n], dtype=np.uint8)
    lens = np.ascontiguousarray(lengths[:n], dtype=np.int64)
    bs = np.ascontiguousarray(out_np["best_score"][:n], dtype=np.int64)
    bp = np.ascontiguousarray(out_np["best_bp"][:n], dtype=np.int64)
    ba = np.ascontiguousarray(out_np["best_anchor"][:n], dtype=np.int64)
    ss = np.ascontiguousarray(out_np["second_score"][:n], dtype=np.int64)
    g = idx.genome.codes
    if g.dtype != np.uint8 or not g.flags.c_contiguous:
        g = np.ascontiguousarray(g, dtype=np.uint8)
    offs = np.ascontiguousarray(idx.genome.offsets, dtype=np.int64)
    clens = np.ascontiguousarray(idx.genome.lengths, dtype=np.int64)
    L = idx.genome.length
    bucket = arr.shape[1] if arr.ndim == 2 else 0

    kind = np.empty(n, dtype=np.int32)
    flag = np.empty(n, dtype=np.int32)
    ci = np.empty(n, dtype=np.int32)
    pos = np.empty(n, dtype=np.int64)
    mapq = np.empty(n, dtype=np.int32)
    nm = np.empty(n, dtype=np.int32)
    rev = np.empty(n, dtype=np.int32)
    tag = np.empty(n, dtype=np.int32)
    soff = np.empty(8 * n, dtype=np.int64)
    cap = int(n * (10 * bucket + 64) + 4096)
    used = ctypes.c_int64(0)
    for _ in range(3):
        sbuf = ctypes.create_string_buffer(cap)
        rc = lib.btbs_finalize_se(
            arr.ctypes.data_as(_u8p), bucket, _p64(lens), n,
            _p64(bs), _p64(bp), _p64(ba), _p64(ss),
            g.ctypes.data_as(_u8p), L,
            _p64(offs), _p64(clens), len(idx.genome.names),
            cfg.max_errors, int(cfg.indels), int(cfg.report_ambiguous),
            _MQ_TAB.ctypes.data_as(_i32p),
            fx_p, mq_p,
            kind.ctypes.data_as(_i32p),
            flag.ctypes.data_as(_i32p), ci.ctypes.data_as(_i32p),
            _p64(pos), mapq.ctypes.data_as(_i32p), nm.ctypes.data_as(_i32p),
            rev.ctypes.data_as(_i32p), tag.ctypes.data_as(_i32p),
            sbuf, cap, ctypes.byref(used), _p64(soff))
        if rc == 0:
            break
        cap *= 4        # arena overflow: retry larger (pathological MDs)
    else:
        return None     # give up -> numpy fallback

    names = idx.genome.names
    text = sbuf.raw[:used.value].decode("latin-1")
    kind_l = kind.tolist()
    flag_l = flag.tolist()
    ci_l = ci.tolist()
    pos_l = pos.tolist()
    mapq_l = mapq.tolist()
    nm_l = nm.tolist()
    rev_l = rev.tolist()
    tag_l = tag.tolist()
    so = soff.tolist()
    out: list[SamRecord | None] = [None] * n
    for i in range(n):
        k = kind_l[i]
        if k == 0:
            continue
        if k == 2:
            # degenerate alignment: per-read spec fallback (rare)
            from bitmapperbs_tpu_torch.oracle.pipeline import Hit, finalize_hit
            b, p = int(bp[i]) >> 1, int(bp[i]) & 1
            a = int(ba[i])
            fwd = a if b == K.BLOCK_FWD else L - a - int(lens[i])
            second = (Hit(int(ss[i]), 0, 0, 0, 0)
                      if ss[i] < K.INF_SCORE else None)
            out[i] = finalize_hit(
                idx, rc_ref, cfg, arr[i, :lens[i]], quals[i], qnames[i],
                Hit(int(bs[i]), fwd, b, p, a), second,
                flag_extra=flag_extras[i] if flag_extras else 0,
                mapq_override=(mapq_overrides[i] if mapq_overrides
                               else None),
                traceback_pre=(pos_l[i], []))
            continue
        o = 8 * i
        qual = quals[i]
        rv = rev_l[i]
        xr, xg = _TAG4[tag_l[i]]
        out[i] = SamRecord(
            qnames[i], flag_l[i], names[ci_l[i]], pos_l[i], mapq_l[i],
            text[so[o]:so[o] + so[o + 1]],
            "*", 0, 0,
            text[so[o + 6]:so[o + 6] + so[o + 7]],
            (qual[::-1] if rv else qual) if qual else "*",
            nm_l[i],
            text[so[o + 2]:so[o + 2] + so[o + 3]],
            text[so[o + 4]:so[o + 4] + so[o + 5]],
            xr, xg,
        )
    return out
