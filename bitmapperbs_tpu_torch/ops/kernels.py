"""CUDA kernels and their plain PyTorch versions (counterpart of
bitmapperbs_tpu/ops/pallas_kernels.py and scripts/pallas_gather_proto.py).

    verify_fused  <- verify_fused_pallas / _fused_verify_kernel
    myers         <- myers_pallas / _myers_kernel
    myers_scan    <- myers_scan_pallas / _myers_scan_kernel
    gather_rows   <- make_pallas_gather.gather

The verify wrappers take u32 plane lanes as int64 tensors (ops/u32.py);
gather_rows takes an int32 table and int64 row indices.  On CPU tensors a
wrapper runs its plain version (`*_ref`); on CUDA tensors it checks dtype,
shape and device and launches its kernel from csrc/verify.cu or
csrc/gather.cu, or raises.  `LAUNCHES` counts the kernel launches.

The kernels are built on first use with nvcc for sm_90a into _build/, one
shared library per source (compiled side by side), each named by the hash
of its source and the flags, and bound with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from bitmapperbs_tpu_torch.ops import verify
from bitmapperbs_tpu_torch.ops.u32 import bnot, to_i32

LAUNCHES = {"verify_fused": 0, "myers": 0, "myers_scan": 0, "gather_rows": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", name + ".cu")
           for name in ("verify", "gather")}
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> dict[str, str]:
    """Compile every source of csrc/ (once per source hash), one nvcc per
    source, all started together; returns {source name: .so path}.  The
    compiler's output (ptxas register/spill report) is kept beside each
    library as <name>.log."""
    paths, procs = {}, {}
    for name, source in SOURCES.items():
        with open(source, "rb") as f:
            src = f.read()
        tag = hashlib.sha256(
            src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        paths[name] = os.path.join(BUILD_DIR, f"libbtbs_{name}_{tag}.so")
        if not os.path.exists(paths[name]):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{paths[name]}.tmp.{os.getpid()}"
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                          f"{out}\n{err}")
            continue
        with open(paths[name] + ".log", "w") as f:
            f.write(out + err)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _lib():
    """The bound entry points of both libraries, on one namespace."""
    global _LIB
    if _LIB is None:
        paths = build()
        lib = ctypes.CDLL(paths["verify"])
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.btbs_verify_fused.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32,
                                          i32, i32, vp]
        lib.btbs_verify_fused.restype = ctypes.c_int
        lib.btbs_myers.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32,
                                   vp]
        lib.btbs_myers.restype = ctypes.c_int
        lib.btbs_myers_scan.argtypes = lib.btbs_myers.argtypes
        lib.btbs_myers_scan.restype = ctypes.c_int
        lib.btbs_gather_rows = ctypes.CDLL(paths["gather"]).btbs_gather_rows
        lib.btbs_gather_rows.argtypes = [vp, vp, vp, i64, i64, i32, vp]
        lib.btbs_gather_rows.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _on_cuda(*tensors) -> bool:
    """True for all-CUDA inputs, False for all-CPU ones; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"kernel inputs on mixed/unsupported devices: {kinds}")


def _rows_i32(planes, lanes, width: int) -> torch.Tensor:
    """u32 planes, each int64 [..., width] broadcastable to lanes -> int32
    [L, len(planes) * width] contiguous rows (lane-major)."""
    for p in planes:
        if p.dtype != torch.int64 or p.shape[-1] != width:
            raise ValueError(f"expected int64 [..., {width}] planes, got "
                             f"{p.dtype} {tuple(p.shape)}")
    rows = torch.cat([p.expand(*lanes, width).reshape(-1, width)
                      for p in planes], dim=-1)
    return to_i32(rows).contiguous()


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


# ---- fused Hamming + Myers verify ------------------------------------------

def verify_fused_ref(win, read_planes, lenmask, m: int, ncols: int, e: int):
    """Plain version: the reference's compact-path sequence
    hamming(shift(wide)) -> PEQ from read planes -> myers(wide) -> select."""
    Wd = m // 32
    ham = verify.hamming(verify.shift_planes(win, e, Wd), read_planes,
                         lenmask)
    peq, pad = verify.peq_from_planes(*read_planes, bnot(lenmask))
    med = verify.myers(win, peq, pad, m, ncols)
    return torch.where(ham <= e, ham, med)


def verify_fused(win, read_planes, lenmask, m: int, ncols: int, e: int):
    """win: 3 x int64 [..., Ww] window planes at anchor - e; read_planes:
    3 x int64 [..., Wd]; lenmask int64 [..., Wd].  Returns int32 lanes:
    ham if ham <= e else the semi-global Myers distance."""
    if not _on_cuda(*win, *read_planes, lenmask):
        return verify_fused_ref(win, read_planes, lenmask, m, ncols, e)
    Wd, Ww = m // 32, win[0].shape[-1]
    lanes = lenmask.shape[:-1]
    w = _rows_i32(win, lanes, Ww)
    r = _rows_i32(read_planes, lanes, Wd)
    lm = _rows_i32((lenmask,), lanes, Wd)
    L = w.shape[0]
    out = torch.empty(L, dtype=torch.int32, device=w.device)
    if L:
        stream = torch.cuda.current_stream(w.device).cuda_stream
        _check_rc(_lib().btbs_verify_fused(
            w.data_ptr(), r.data_ptr(), lm.data_ptr(), out.data_ptr(), L, Wd,
            Ww, m, ncols, e, stream), "btbs_verify_fused")
        LAUNCHES["verify_fused"] += 1
    return out.reshape(lanes)


# ---- Myers from a precomputed PEQ (dense path, mate-rescue scan) ---------

def _myers_rows(win, peq, pad, m: int):
    """(win, peq, pad) broadcast to their common lanes -> lane-major int32
    rows (w, q, p) and the lane shape.  Broadcast PEQ/pad tables are
    materialized per lane (the dense gdrop grid at 2.1 M lanes makes
    ~100 MB of them)."""
    Wd, Ww = m // 32, win[0].shape[-1]
    lanes = torch.broadcast_shapes(win[0].shape[:-1], peq.shape[:-2],
                                   pad.shape[:-1])
    w = _rows_i32(win, lanes, Ww)
    if peq.dtype != torch.int64 or tuple(peq.shape[-2:]) != (4, Wd):
        raise ValueError(f"expected int64 [..., 4, {Wd}] peq, got "
                         f"{peq.dtype} {tuple(peq.shape)}")
    q = _rows_i32((peq.expand(*lanes, 4, Wd).reshape(*lanes, 4 * Wd),),
                  lanes, 4 * Wd)
    p = _rows_i32((pad,), lanes, Wd)
    return w, q, p, lanes


def myers_ref(win, peq, pad, m: int, ncols: int):
    """Plain version: ops/verify.myers."""
    return verify.myers(win, peq, pad, m, ncols)


def myers(win, peq, pad, m: int, ncols: int):
    """win: 3 x int64 [..., Ww]; peq int64 [..., 4, Wd]; pad int64
    [..., Wd] (broadcastable).  Returns int32 lanes."""
    if not _on_cuda(*win, peq, pad):
        return myers_ref(win, peq, pad, m, ncols)
    w, q, p, lanes = _myers_rows(win, peq, pad, m)
    L = w.shape[0]
    out = torch.empty(L, dtype=torch.int32, device=w.device)
    if L:
        stream = torch.cuda.current_stream(w.device).cuda_stream
        _check_rc(_lib().btbs_myers(
            w.data_ptr(), q.data_ptr(), p.data_ptr(), out.data_ptr(), L,
            m // 32, win[0].shape[-1], m, ncols, stream), "btbs_myers")
        LAUNCHES["myers"] += 1
    return out.reshape(lanes)


def myers_scan_ref(win, peq, pad, m: int, ncols: int):
    """Plain version: ops/verify.myers_scan."""
    return verify.myers_scan(win, peq, pad, m, ncols)


def myers_scan(win, peq, pad, m: int, ncols: int):
    """As `myers`, but returns every column's running score: int32
    [..., ncols].  The kernel stores column-major ([ncols, L]); the result
    is its transpose, a view."""
    if not _on_cuda(*win, peq, pad):
        return myers_scan_ref(win, peq, pad, m, ncols)
    w, q, p, lanes = _myers_rows(win, peq, pad, m)
    L = w.shape[0]
    out = torch.empty((ncols, L), dtype=torch.int32, device=w.device)
    if L:
        stream = torch.cuda.current_stream(w.device).cuda_stream
        _check_rc(_lib().btbs_myers_scan(
            w.data_ptr(), q.data_ptr(), p.data_ptr(), out.data_ptr(), L,
            m // 32, win[0].shape[-1], m, ncols, stream), "btbs_myers_scan")
        LAUNCHES["myers_scan"] += 1
    return out.t().reshape(*lanes, ncols)


# ---- table row gather --------------------------------------------------------

def gather_rows_ref(table, idx):
    """Plain version: table[idx] with idx clamped into the table."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def gather_rows(table, idx):
    """table int32 [R, W] (contiguous); idx int64 lanes of any shape
    (contiguous).  Returns int32 [..., W]: row idx of the table per lane,
    idx clamped into [0, R - 1]."""
    if not _on_cuda(table, idx):
        return gather_rows_ref(table, idx)
    if table.dtype != torch.int32 or table.dim() != 2 \
            or not table.is_contiguous() or table.shape[0] < 1 \
            or table.shape[1] < 1:
        raise ValueError(f"expected a contiguous int32 [R, W] table, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int64 or not idx.is_contiguous():
        raise ValueError(f"expected contiguous int64 row indices, got "
                         f"{idx.dtype} {tuple(idx.shape)} strides "
                         f"{idx.stride()}")
    R, W = table.shape
    L = idx.numel()
    out = torch.empty((*idx.shape, W), dtype=torch.int32, device=table.device)
    if L:
        stream = torch.cuda.current_stream(table.device).cuda_stream
        _check_rc(_lib().btbs_gather_rows(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, L, W,
            stream), "btbs_gather_rows")
        LAUNCHES["gather_rows"] += 1
    return out
