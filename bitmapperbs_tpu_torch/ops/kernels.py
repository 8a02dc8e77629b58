"""CUDA kernels and their plain PyTorch versions (counterpart of
bitmapperbs_tpu/ops/pallas_kernels.py and scripts/pallas_gather_proto.py).

    verify_fused_gather  <- verify_fused_pallas / _fused_verify_kernel with
                            ops/verify.window_planes in front of it, as the
                            compact path runs them
    myers                <- myers_pallas / _myers_kernel
    rescue_scan          <- myers_scan_pallas / _myers_scan_kernel with what
                            paired-end mate rescue runs around it: the window
                            gather in front, the best / position /
                            second-best selection behind
    gather_rows          <- make_pallas_gather.gather
    gather_rows_shard    <- the same gather over one shard of a table split
                            into row ranges (rows outside it are zero), as
                            the reference's sharded-index fetches run it
    fm_search, fm_extend, fm_locate
                         <- that row gather fused with the FM-index step it
                            feeds, the step loops of ops/fm.search_patterns,
                            extend_seeds and locate inside one launch each
    pair_join            <- no Pallas kernel: the PE proper-pair join, plain
                            jnp under jit in the reference
                            (bitmapperbs_tpu/models/paired.py:80-145)
    flat_expand, flat_dedup, scatter_back, select_se
                         <- no Pallas kernel: the compact candidate stage's
                            flat buffer and the selection, plain jnp under
                            jit in the reference
                            (bitmapperbs_tpu/models/aligner.py:111-120,
                            366-437, 490-548); their lane counts n_used
                            and n_valid stay on the card, where fm_locate
                            and verify_fused_gather take them (`n_lanes`)

The verify wrappers take u32 plane lanes as int64 tensors (ops/u32.py);
gather_rows takes an int32 table and int64 row indices; the FM wrappers take
the device index and int64 lanes; pair_join the two mates' (B, F, Kc)
candidate grids; the flat-buffer wrappers the compact path's lanes.  On CPU
tensors a wrapper runs its plain version (`*_ref`); on CUDA tensors it
checks dtype, shape and device and launches its kernel from csrc/verify.cu,
csrc/gather.cu, csrc/fm.cu, csrc/pair.cu or csrc/flat.cu, or raises.
`LAUNCHES` counts the kernel launches.  A launch goes to the card its lanes
are on (`_launching` makes that card current for the call), on that card's
current stream, so a CUDA graph being captured there records it
(models/graphs.py).

A table split over cards (index/device.Shards: the sharded index's
checkpoint rows, SA samples and genome planes) goes to the fused kernels as
it is: fm_search, fm_extend, fm_locate, verify_fused_gather and rescue_scan
launch their SHARD instance, which reads each row from the shard that holds
it (a zero row past the table, as the reference's sharded fetch gives) and
reaches shards on other cards through peer access (`enable_peer_access`,
called where a sharded index is placed).  Their plain versions read a shard
set through `gather_table`.  gather_rows takes a whole table only.

The kernels are built on first use with nvcc for sm_90a into _build/, one
shared library per source (compiled side by side), each named by the hash
of its source, the shared headers csrc/shards.cuh and csrc/smem.cuh and the
flags, and bound with ctypes.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.index.device import Shards
from bitmapperbs_tpu_torch.models import aligner   # mutual: used in calls
from bitmapperbs_tpu_torch.ops import fm, verify   # mutual: used in calls
from bitmapperbs_tpu_torch.ops.u32 import INVALID, MASK, bnot, to_i32, wrap

LAUNCHES = {"verify_fused_gather": 0, "myers": 0, "rescue_scan": 0,
            "gather_rows": 0, "gather_rows_shard": 0, "fm_search": 0,
            "fm_extend": 0, "fm_locate": 0, "pair_join": 0,
            "flat_expand": 0, "flat_dedup": 0, "scatter_back": 0,
            "select_se": 0}

MAX_WORDS = 32                  # read words the kernels take (1,024 bp)
# verify_fused_gather over 8 read words: a lane on ceil(words / K) threads
# of one warp, K read words per thread from the first bucket capacity that
# holds the words (csrc/verify.cu builds K = 4, 5, 6, 8; chosen by timing on
# the H100, PERF.md section 6)
WIDE_WORDS = {12: 5, 16: 4, 24: 6, 32: 8}
# btbs_rescue_scan's launch shape (csrc/verify.cu: kThreads, kSharedLimit and
# the word capacities of the instances that keep PEQ in shared memory)
_RESCUE_BLOCK = 128
_RESCUE_SHARED_BYTES = 227 * 1024
_RESCUE_WIDE_WORDS = (12, 16, 24, 32)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", name + ".cu")
           for name in ("verify", "gather", "fm", "pair", "flat")}
HEADERS = tuple(os.path.join(_PKG, "csrc", name)
                for name in ("shards.cuh", "smem.cuh"))
MAX_SHARDS = 8                  # parts of a shard set (csrc/shards.cuh)
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
    headers = b""
    for header in HEADERS:
        with open(header, "rb") as f:
            headers += f.read()
    for name, source in SOURCES.items():
        with open(source, "rb") as f:
            src = f.read() + headers
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
    """The bound entry points of the five libraries, on one namespace."""
    global _LIB
    if _LIB is None:
        paths = build()
        lib = ctypes.CDLL(paths["verify"])
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        planes = [vp, vp, i32, i64]       # gp, gp_parts, nparts, gp_rows
        lib.btbs_verify_fused_gather.argtypes = planes + [
            vp, vp, vp, vp, vp, vp, vp, i64, i64, i64, i64, i32, i32, i32,
            i32, i32, vp]
        lib.btbs_verify_fused_gather.restype = ctypes.c_int
        lib.btbs_myers.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32,
                                   vp]
        lib.btbs_myers.restype = ctypes.c_int
        lib.btbs_rescue_scan.argtypes = (
            planes + [vp, i64] * 6 + [vp, i64, i64, i64, vp, i64, i64]
            + [vp, vp, vp, i64, i64, i64, i32, i32, i32, i32, i32, i32, vp])
        lib.btbs_rescue_scan.restype = ctypes.c_int
        glib = ctypes.CDLL(paths["gather"])
        lib.btbs_gather_rows = glib.btbs_gather_rows
        lib.btbs_gather_rows.argtypes = [vp, vp, vp, i64, i64, i32, vp]
        lib.btbs_gather_rows_shard = glib.btbs_gather_rows_shard
        lib.btbs_gather_rows_shard.argtypes = [vp, vp, vp, i64, i64, i32, i64,
                                               vp]
        lib.btbs_enable_peer_access = glib.btbs_enable_peer_access
        lib.btbs_enable_peer_access.argtypes = [i32, i32]
        for fn in (lib.btbs_gather_rows, lib.btbs_gather_rows_shard,
                   lib.btbs_enable_peer_access):
            fn.restype = ctypes.c_int
        fmlib = ctypes.CDLL(paths["fm"])
        # cp, sa, cp_parts, sa_parts, nparts, R, n_samples, rows_max,
        # samples_max, cbase, n
        index = [vp, vp, vp, vp, i32, i64, i64, i64, i64, vp, vp]
        pat = [vp, i64, i64, i64, i64, i64, i32]
        lib.btbs_fm_search = fmlib.btbs_fm_search
        lib.btbs_fm_search.argtypes = index + pat + [
            vp, vp, vp, vp, vp, i32, i32, vp, vp, vp, i64, vp]
        lib.btbs_fm_extend = fmlib.btbs_fm_extend
        lib.btbs_fm_extend.argtypes = index + pat + [
            vp, vp, vp, vp, i32, i64, vp, vp, vp, vp, i64, vp]
        lib.btbs_fm_locate = fmlib.btbs_fm_locate
        lib.btbs_fm_locate.argtypes = index + [
            i32, vp, vp, vp, vp, vp, vp, i64, vp]
        lib.btbs_dependent_load_chain = fmlib.btbs_dependent_load_chain
        lib.btbs_dependent_load_chain.argtypes = [vp, i64, i32,
                                                  ctypes.c_uint32, vp, vp]
        for fn in (lib.btbs_fm_search, lib.btbs_fm_extend, lib.btbs_fm_locate,
                   lib.btbs_dependent_load_chain):
            fn.restype = ctypes.c_int
        plib = ctypes.CDLL(paths["pair"])
        lib.btbs_pair_join = plib.btbs_pair_join
        lib.btbs_pair_join.argtypes = [vp] * 15 + [
            i64, i32, i32, i32, i64, i64, i64, i64, vp, i32, vp]
        lib.btbs_pair_join.restype = ctypes.c_int
        flib = ctypes.CDLL(paths["flat"])
        lib.btbs_flat_expand = flib.btbs_flat_expand
        lib.btbs_flat_expand.argtypes = [vp, vp, vp, i64, i64, i64, vp, i64,
                                         i32, i32, i64, i64, i64, i32] \
            + [vp] * 11
        lib.btbs_flat_dedup = flib.btbs_flat_dedup
        lib.btbs_flat_dedup.argtypes = [vp] * 4 + [i64, i64, i32, i32, i64] \
            + [vp] * 9
        lib.btbs_scatter_back = flib.btbs_scatter_back
        lib.btbs_scatter_back.argtypes = [vp] * 5 + [
            i64, i64, i32, i64, i32, i64, i32, vp, vp, vp, vp]
        lib.btbs_select_se = flib.btbs_select_se
        lib.btbs_select_se.argtypes = [vp] * 4 + [
            i64, i64, i64, i64, i32, i64, i64, vp, vp, vp, vp, vp]
        for fn in (lib.btbs_flat_expand, lib.btbs_flat_dedup,
                   lib.btbs_scatter_back, lib.btbs_select_se):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@contextlib.contextmanager
def _launching(dev: torch.device):
    """Makes `dev` the calling thread's current CUDA device for a launch
    (a ctypes launch goes to the current device, and the kernels' shared-
    memory opt-ins are set per device); yields its current stream."""
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def _check_shards(t: Shards, name: str) -> None:
    """Raise unless the kernels take this shard set: 1..MAX_SHARDS parts of
    one shape, int32, contiguous, fewer than 2^32 rows in all."""
    shapes = {tuple(p.shape) for p in t.parts}
    if not 1 <= len(t.parts) <= MAX_SHARDS or len(shapes) != 1:
        raise ValueError(f"{name}: the kernels take 1..{MAX_SHARDS} shards of "
                         f"one shape, got {len(t.parts)} shards of shapes "
                         f"{sorted(shapes)}")
    if any(p.dtype != torch.int32 or not p.is_contiguous() or p.dim() < 1
           for p in t.parts) or t.rows < 1 \
            or t.rows * len(t.parts) > 0xFFFFFFFF:
        raise ValueError(f"{name}: expected contiguous int32 shards of fewer "
                         f"than 2^32 rows in all")


def _on_cuda(*tensors) -> bool:
    """True for all-CUDA inputs, False for all-CPU ones; raises otherwise.
    The lanes and whole tables share one device; the parts of a shard set
    (index/device.Shards) may sit on other cards, which the kernels reach
    through peer access."""
    flat = [t for t in tensors if not isinstance(t, Shards)]
    kinds = {t.device.type for t in flat} | {
        p.device.type for t in tensors if isinstance(t, Shards)
        for p in t.parts}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in flat}) == 1:
        return True
    raise ValueError(f"kernel inputs on mixed/unsupported devices: {kinds}")


def _table_args(table) -> list:
    """A checked table as the kernels take it: [pointer, parts, nparts,
    rows].  A whole tensor: its pointer, no parts, its rows.  A shard set:
    no pointer, a ctypes array of its parts' pointers, their count and the
    rows of each (the caller holds the list until its launch is queued)."""
    if not isinstance(table, Shards):
        return [table.data_ptr(), None, 0, table.shape[0]]
    ptrs = (ctypes.c_void_p * len(table.parts))(
        *(p.data_ptr() for p in table.parts))
    return [None, ptrs, len(table.parts), table.rows]


def enable_peer_access(dev, peers) -> None:
    """Lets the kernels launched on card `dev` read tensors on each card of
    `peers` (an index group's shards, its lanes on `dev`).  Idempotent; no-op
    for CPU devices and for `dev` itself.  Raises ValueError, naming both
    cards, where the pair has no peer access: a sharded index is refused at
    placement, never mapped some other way."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return
    a = torch.cuda.current_device() if dev.index is None else dev.index
    for peer in map(torch.device, peers):
        if peer.type != "cuda":
            continue
        b = torch.cuda.current_device() if peer.index is None else peer.index
        if b == a:
            continue
        if not torch.cuda.can_device_access_peer(a, b):
            raise ValueError(
                f"cuda:{a} cannot read cuda:{b} (no peer access): a sharded "
                f"index keeps its lanes on cuda:{a} and a shard on cuda:{b}")
        _check_rc(_lib().btbs_enable_peer_access(a, b),
                  "btbs_enable_peer_access")


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


def _require(dtype, **tensors) -> None:
    """Raise unless every named tensor has `dtype` (on any device: the
    plain versions take the same types as the kernels)."""
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"expected {dtype} {name}, got {t.dtype}")


def _lanes_i64(t, lanes) -> torch.Tensor:
    """An int64 lane tensor broadcast to `lanes`, flat and contiguous."""
    if t.shape == lanes and t.is_contiguous():
        return t.view(-1)
    return t.expand(lanes).contiguous().view(-1)


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def _check_count(n_lanes, lanes) -> None:
    """Raise unless n_lanes (a lane count on the lanes' device) is None or
    an int64 [1] tensor beside 1-D lanes."""
    if n_lanes is None:
        return
    if n_lanes.dtype != torch.int64 or tuple(n_lanes.shape) != (1,) \
            or len(lanes) != 1:
        raise ValueError(f"expected an int64 [1] lane count beside 1-D "
                         f"lanes, got {n_lanes.dtype} "
                         f"{tuple(n_lanes.shape)} for lanes {tuple(lanes)}")


def _past_count(out, n_lanes, fill):
    """`out` (1-D lanes) with every lane at or past the count n_lanes set to
    `fill`, as the kernels write them: the plain versions' lane-count
    rule."""
    if n_lanes is None:
        return out
    ar = torch.arange(out.shape[0], dtype=torch.int64, device=out.device)
    return torch.where(ar < n_lanes, out, fill)


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


# ---- fused verify with the window gather inside ------------------------------

def _check_planes(g_planes, g_words: int) -> None:
    """Raise unless the gathering kernels take these genome planes: a shard
    set of [rows, 3] parts (checked on any device: the plain versions take
    what the kernels take), or on the card a contiguous int32 [2 * g_words,
    3] tensor."""
    if isinstance(g_planes, Shards):
        _check_shards(g_planes, "g_planes")
        if g_planes.parts[0].dim() != 2 or g_planes.parts[0].shape[1] != 3:
            raise ValueError(f"expected [rows, 3] genome-plane shards, got "
                             f"{tuple(g_planes.parts[0].shape)}")
    elif g_planes.device.type == "cuda" and (
            g_planes.dtype != torch.int32 or not g_planes.is_contiguous()
            or tuple(g_planes.shape) != (2 * g_words, 3)):
        raise ValueError(f"expected contiguous int32 [{2 * g_words}, 3] "
                         f"genome planes, got {g_planes.dtype} "
                         f"{tuple(g_planes.shape)}")


def verify_fused_gather_fits(m: int, ncols: int) -> bool:
    """Whether the gathering entry takes these widths: 1..MAX_WORDS read
    words (every bucket up to 1,024 bp) and a window of exactly one word
    more (1 <= e <= 16; the configuration allows e up to 15)."""
    Wd = m // 32
    return m % 32 == 0 and 1 <= Wd <= MAX_WORDS \
        and -(-ncols // 32) == Wd + 1


def verify_fused_gather_ref(g_planes, orient, start, read_tab, row, lens,
                            genome_len: int, g_words: int, m: int,
                            ncols: int, e: int, n_lanes=None):
    """Plain version: ops/verify.window_planes at `start`, the read planes
    picked from their table, the length mask, then verify_fused_ref; lanes
    at or past n_lanes INF."""
    Wd = m // 32
    wide = verify.window_planes(g_planes, orient, start, -(-ncols // 32),
                                genome_len, g_words)
    rp = read_tab[row]
    out = verify_fused_ref(
        wide, (rp[..., :Wd], rp[..., Wd:2 * Wd], rp[..., 2 * Wd:]),
        verify.length_mask(lens, m), m, ncols, e)
    return _past_count(out, n_lanes, K.INF_SCORE)


def wide_words(words: int) -> int:
    """The read words per thread K of verify_fused_gather's kernel for a
    bucket of 9..32 read words (a lane on ceil(words / K) threads)."""
    return next(k for nw, k in WIDE_WORDS.items() if words <= nw)


def verify_fused_gather(g_planes, orient, start, read_tab, row, lens,
                        genome_len: int, g_words: int, m: int, ncols: int,
                        e: int, words_per_thread: int | None = None,
                        n_lanes=None):
    """The fused Hamming + Myers verify (verify_fused_ref) on windows it
    fetches itself.  g_planes: int32 bits [2 * g_words, 3]
    (index/device.py), or their shard set; per lane (int64, one shape):
    orient (0 fwd / 1 rc), start (u32 window start, anchor - e, possibly
    wrapped below 0), row (into read_tab) and lens (read length); read_tab:
    int64 u32 [R, 3 * Wd] read planes (b0 | b1 | nmask words).  Returns int32
    lanes: ham if ham <= e else the semi-global Myers distance.  n_lanes:
    None, or an int64 [1] count on the lanes' device (1-D lanes): lanes at
    or past it give INF_SCORE and, on the card, load nothing."""
    lane_t = (orient, start, row, lens)
    _check_planes(g_planes, g_words)
    _require(torch.int64, orient=orient, start=start, row=row, lens=lens,
             read_tab=read_tab)
    _check_count(n_lanes, torch.broadcast_shapes(*(t.shape for t in lane_t)))
    counts = () if n_lanes is None else (n_lanes,)
    if not _on_cuda(g_planes, read_tab, *lane_t, *counts):
        return verify_fused_gather_ref(g_planes, orient, start, read_tab, row,
                                       lens, genome_len, g_words, m, ncols, e,
                                       n_lanes)
    Wd = m // 32
    if not verify_fused_gather_fits(m, ncols) or not 0 <= e <= 31:
        raise ValueError(f"verify_fused_gather takes 1..{MAX_WORDS} read "
                         f"words, a window of one more and e <= 31; got "
                         f"m {m}, ncols {ncols}, e {e}")
    if read_tab.dim() != 2 \
            or read_tab.shape[1] != 3 * Wd or read_tab.shape[0] < 1 \
            or not read_tab.is_contiguous():
        raise ValueError(f"expected a contiguous int64 [R, {3 * Wd}] read-"
                         f"plane table, got {read_tab.dtype} "
                         f"{tuple(read_tab.shape)}")
    lanes = torch.broadcast_shapes(*(t.shape for t in lane_t))
    o, s, r, n = (_lanes_i64(t, lanes) for t in lane_t)
    L = o.numel()
    out = torch.empty(L, dtype=torch.int32, device=o.device)
    if L:
        with _launching(o.device) as stream:
            _check_rc(_lib().btbs_verify_fused_gather(
                *_table_args(g_planes), o.data_ptr(), s.data_ptr(),
                read_tab.data_ptr(), r.data_ptr(), n.data_ptr(),
                None if n_lanes is None else n_lanes.data_ptr(),
                out.data_ptr(), L, read_tab.shape[0], g_words, genome_len, Wd,
                m, ncols, e, words_per_thread or (
                    wide_words(Wd) if Wd > 8 else 0), stream),
                "btbs_verify_fused_gather")
        LAUNCHES["verify_fused_gather"] += 1
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
        with _launching(w.device) as stream:
            _check_rc(_lib().btbs_myers(
                w.data_ptr(), q.data_ptr(), p.data_ptr(), out.data_ptr(), L,
                m // 32, win[0].shape[-1], m, ncols, stream), "btbs_myers")
        LAUNCHES["myers"] += 1
    return out.reshape(lanes)


# ---- paired-end mate rescue: window gather + Myers scan + selection --------

def rescue_scan_chunks(m: int, e: int, R: int) -> tuple[int, bool]:
    """(threads per pair, two passes) of `rescue_scan`: 8 threads, or 16 or
    32 where the insert range is so wide that a block of 128 / 8 pairs would
    not fit its one byte per output column (and, for reads over 256 bp, its
    PEQ table) into the 227 KB of shared memory a block may take.  Where 32
    threads per pair do not fit either (past ~58,000 offsets; ~37,000 at
    1,024 bp), 32 threads in two passes that keep no byte per column: the
    first finds the best score and its position, the second the best score
    more than e anchors away from it."""
    Wd = m // 32
    table = 0 if Wd <= 8 else 5 * 4 * _RESCUE_BLOCK * next(
        nw for nw in _RESCUE_WIDE_WORDS if Wd <= nw)
    per_pair = (R + e + 4) & ~3
    for chunks in (8, 16, 32):
        if table + _RESCUE_BLOCK // chunks * per_pair <= _RESCUE_SHARED_BYTES:
            return chunks, False
    return 32, True


def rescue_scan_ref(g_planes, block, win_start, r_ok, a_lo, span, ms_len,
                    ms_peq, ms_pad, genome_len: int, g_words: int, m: int,
                    e: int, R: int):
    """Plain version: ops/verify.window_planes over the whole insert window,
    ops/verify.myers_scan, then the selection on the [B, ncols] scores."""
    ncols = R + m + 2 * e
    L = genome_len
    win = verify.window_planes(g_planes, block, win_start, -(-ncols // 32),
                               L, g_words)
    S = verify.myers_scan(win, ms_peq, ms_pad, m, ncols)   # B, ncols
    # real frame anchor of column j: a_lo + (j - (e + m - 1)); valid iff
    # j >= e+m-1 and j - (e+m-1) <= span, span read as int32 (as the
    # reference casts it)
    joff = torch.arange(ncols, dtype=torch.int64,
                        device=S.device) - (e + m - 1)
    span_i32 = (span ^ 0x80000000) - 0x80000000
    in_range = (joff >= 0) & (joff <= span_i32[:, None])
    A_raw = wrap(a_lo[:, None] + joff.clamp(min=0))
    valid = r_ok[:, None] & in_range & (S <= e)
    P = verify.frame_anchor(A_raw, block[:, None], ms_len[:, None], L)
    rs_best = torch.where(valid, S, K.INF_SCORE).amin(dim=-1)
    rm1 = valid & (S == rs_best[:, None])
    rp_best = torch.where(rm1, P, INVALID).amin(dim=-1)
    A_best = verify.frame_anchor(rp_best, block, ms_len, L)
    rdiff = torch.maximum(A_raw, A_best[:, None]) - torch.minimum(
        A_raw, A_best[:, None])
    rs_second = torch.where(valid & (rdiff > e), S,
                            K.INF_SCORE).amin(dim=-1)
    return rs_best, rp_best, rs_second


def rescue_scan(g_planes, block, win_start, r_ok, a_lo, span, ms_len, ms_peq,
                ms_pad, genome_len: int, g_words: int, m: int, e: int, R: int):
    """Mate rescue of B pairs in one launch.  Per pair (int64 [B] unless
    said): block (0 fwd / 1 rc), win_start (u32 start of the scan window,
    a_lo - e, possibly wrapped below 0), r_ok (bool: a rescue window
    exists), a_lo (u32 frame anchor of the window's first offset), span
    (u32, read as int32: offsets 0..span are valid), ms_len (the missing
    mate's length), ms_peq int64 u32 [B, 4, Wd] and ms_pad [B, Wd] (its PEQ
    and pad words; any strides).  g_planes: int32 bits [2 * g_words, 3], or
    their shard set.
    The window has R + m + 2e columns.
    Returns (rs_best int32, rp_best u32 as int64, rs_second int32), [B]
    each: the best semi-global score <= e over the valid end columns, the
    lowest frame position among the columns that reach it, and the best
    score more than e anchors away from it; INF_SCORE / 0xFFFFFFFF /
    INF_SCORE where there is none.  One launch, or two where the insert
    range is too wide for one (`rescue_scan_chunks`)."""
    lane_t = dict(block=block, win_start=win_start, a_lo=a_lo, span=span,
                  ms_len=ms_len)
    _check_planes(g_planes, g_words)
    _require(torch.int64, ms_peq=ms_peq, ms_pad=ms_pad, **lane_t)
    _require(torch.bool, r_ok=r_ok)
    if not _on_cuda(g_planes, r_ok, ms_peq, ms_pad, *lane_t.values()):
        return rescue_scan_ref(g_planes, block, win_start, r_ok, a_lo, span,
                               ms_len, ms_peq, ms_pad, genome_len, g_words,
                               m, e, R)
    B, Wd = r_ok.shape[0], m // 32
    if m % 32 or not 1 <= Wd <= MAX_WORDS or not 0 <= e <= 31 or R < 1:
        raise ValueError(f"rescue_scan takes 1..{MAX_WORDS} read words, "
                         f"e <= 31 and R >= 1; got m {m}, e {e}, R {R}")
    chunks, two_pass = rescue_scan_chunks(m, e, R)
    for name, t in (("r_ok", r_ok), *lane_t.items()):
        if tuple(t.shape) != (B,):
            raise ValueError(f"expected [{B}] {name}, got {tuple(t.shape)}")
    if tuple(ms_peq.shape) != (B, 4, Wd) or tuple(ms_pad.shape) != (B, Wd):
        raise ValueError(f"expected peq [{B}, 4, {Wd}] and pad [{B}, {Wd}], "
                         f"got {tuple(ms_peq.shape)} and "
                         f"{tuple(ms_pad.shape)}")
    dev = r_ok.device
    rs_best = torch.empty(B, dtype=torch.int32, device=dev)
    rp_best = torch.empty(B, dtype=torch.int64, device=dev)
    rs_second = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        lanes = [x for t in (block, win_start, r_ok, a_lo, span, ms_len)
                 for x in (t.data_ptr(), t.stride(0))]
        # mode 0: one pass; 1 then 2: the two passes (pass 2 reads pass 1's
        # rs_best / rp_best)
        for mode in ((1, 2) if two_pass else (0,)):
            with _launching(dev) as stream:
                _check_rc(_lib().btbs_rescue_scan(
                    *_table_args(g_planes), *lanes, ms_peq.data_ptr(),
                    *ms_peq.stride(), ms_pad.data_ptr(), *ms_pad.stride(),
                    rs_best.data_ptr(), rp_best.data_ptr(),
                    rs_second.data_ptr(), B, g_words, genome_len, Wd, m, e, R,
                    chunks, mode, stream), "btbs_rescue_scan")
            LAUNCHES["rescue_scan"] += 1
    return rs_best, rp_best, rs_second


# ---- paired-end proper-pair join --------------------------------------------

# bp code -> is-reverse (bp = block*2 + pat; see constants.IS_REVERSE)
REV_BY_BP = [K.IS_REVERSE[(bp >> 1, bp & 1)] for bp in range(4)]
_MAX_FRAME_PAIRS = 4            # csrc/pair.cu kMaxFramePairs (PBAT)


def lex_lt(a: tuple, b: tuple):
    """Elementwise lexicographic a < b over equal-length tuples of tensors."""
    lt = eq = None
    for x, y in zip(a, b):
        if lt is None:
            lt, eq = x < y, x == y
        else:
            lt = lt | (eq & (x < y))
            eq = eq & (x == y)
    return lt


def frame_pairs(frames1, frames2) -> list[tuple[int, int, int, int, bool]]:
    """The compatible frame pairs (same block, opposite pattern) of the two
    mates' (pattern, block) frames: (mate-1 frame, mate-2 frame, bp1, bp2,
    mate 1 is the forward mate), in the reference's order."""
    return [(i1, i2, b1 * 2 + p1, b2 * 2 + p2, not REV_BY_BP[b1 * 2 + p1])
            for i1, (p1, b1) in enumerate(frames1)
            for i2, (p2, b2) in enumerate(frames2)
            if b1 == b2 and p1 != p2]


def pair_join_ref(s1, f1, s2, f2, frames1, frames2, m1, m2,
                  genome_len: int, e: int, min_insert: int, max_insert: int):
    """Plain version: one (B, Kc, Kc) torch.where grid per compatible frame
    pair and staged reduction, as the reference writes it under jit."""
    B = m1.shape[0]
    L = genome_len
    dev = m1.device

    def full(v, dtype=torch.int64):
        return torch.full((B,), v, dtype=dtype, device=dev)

    best = (full(2 * K.INF_SCORE, torch.int32), full(INVALID), full(INVALID),
            full(127), full(127))
    best_s1 = full(K.INF_SCORE, torch.int32)  # payload: mate-1 score of best
    pair_data = []
    for i1, i2, bp1, bp2, fwd1 in frame_pairs(frames1, frames2):
        s1_, f1_ = s1[:, i1, :, None], f1[:, i1, :, None]
        s2_, f2_ = s2[:, i2, None, :], f2[:, i2, None, :]
        if fwd1:                          # mate 1 is the forward mate
            ffwd, frev, mrev = f1_, f2_, m2[:, None, None]
        else:
            ffwd, frev, mrev = f2_, f1_, m1[:, None, None]
        insert = wrap(frev + mrev - ffwd)
        ok = ((s1_ < K.INF_SCORE) & (s2_ < K.INF_SCORE) & (ffwd <= frev)
              & (insert >= min_insert) & (insert <= max_insert))
        ssum = torch.where(ok, s1_ + s2_, 2 * K.INF_SCORE)    # B,Kc,Kc

        # staged lexicographic min inside this grid
        smin = ssum.reshape(B, -1).amin(dim=-1)
        at_min = ssum == smin[:, None, None]
        f1min = torch.where(at_min, f1_, INVALID).reshape(B, -1).amin(dim=-1)
        m2sel = at_min & (f1_ == f1min[:, None, None])
        f2min = torch.where(m2sel, f2_, INVALID).reshape(B, -1).amin(dim=-1)
        cand = (smin, f1min, f2min, full(bp1), full(bp2))
        # mate-1 score of the selected cell (unique per read)
        m3sel = m2sel & (f2_ == f2min[:, None, None])
        s1min = torch.where(m3sel, s1_, K.INF_SCORE).reshape(B, -1).amin(
            dim=-1)
        take = lex_lt(cand, best)
        best = tuple(torch.where(take, c, b) for c, b in zip(cand, best))
        best_s1 = torch.where(take, s1min, best_s1)
        pair_data.append((ssum, f1_, f2_, bp1, bp2))

    _, pf1, pf2, pbp1, pbp2 = best
    pa1 = verify.frame_anchor(pf1, pbp1 >> 1, m1, L)
    pa2 = verify.frame_anchor(pf2, pbp2 >> 1, m2, L)
    second = full(2 * K.INF_SCORE, torch.int32)
    for ssum, f1_, f2_, bp1, bp2 in pair_data:
        a1 = verify.frame_anchor(f1_, bp1 >> 1, m1[:, None, None], L)
        a2 = verify.frame_anchor(f2_, bp2 >> 1, m2[:, None, None], L)
        b1, b2 = pa1[:, None, None], pa2[:, None, None]
        d1 = (pbp1[:, None, None] != bp1) | (
            torch.maximum(a1, b1) - torch.minimum(a1, b1) > e)
        d2 = (pbp2[:, None, None] != bp2) | (
            torch.maximum(a2, b2) - torch.minimum(a2, b2) > e)
        s = torch.where(d1 | d2, ssum, 2 * K.INF_SCORE).reshape(B, -1).amin(
            dim=-1)
        second = torch.minimum(second, s)
    return best, best_s1, pa1, pa2, second


def pair_join(s1, f1, s2, f2, frames1, frames2, m1, m2, genome_len: int,
              e: int, min_insert: int, max_insert: int):
    """Best proper pair by (sum, fwd1, fwd2, bp1, bp2) and the best pair sum
    at a distinct locus (either mate more than e away, or another frame),
    over the compatible frame pairs of the mates' (pattern, block) frames.
    s1 / s2: int32 [B, F, Kc] scores (INF_SCORE = no candidate), f1 / f2:
    int64 [B, F, Kc] fwd-genome anchors (u32 values), m1 / m2: int64 [B]
    mate lengths.  Returns ((sum int32, fwd1, fwd2, bp1, bp2 int64), the
    best's mate-1 score int32, its frame anchors a1 / a2 int64, the second
    sum int32), [B] each.  One launch on the card (csrc/pair.cu), no
    [B, Kc, Kc] tensor."""
    _require(torch.int32, s1=s1, s2=s2)
    _require(torch.int64, f1=f1, f2=f2, m1=m1, m2=m2)
    if not _on_cuda(s1, f1, s2, f2, m1, m2):
        return pair_join_ref(s1, f1, s2, f2, frames1, frames2, m1, m2,
                             genome_len, e, min_insert, max_insert)
    pairs = frame_pairs(frames1, frames2)
    if s1.dim() != 3 or s2.dim() != 3:
        raise ValueError(f"expected [B, F, Kc] scores, got "
                         f"{tuple(s1.shape)} and {tuple(s2.shape)}")
    B, F1, Kc = s1.shape
    F2 = s2.shape[1]
    if tuple(f1.shape) != (B, F1, Kc) or tuple(s2.shape) != (B, F2, Kc) \
            or tuple(f2.shape) != (B, F2, Kc) or tuple(m1.shape) != (B,) \
            or tuple(m2.shape) != (B,) or (F1, F2) != (len(frames1),
                                                       len(frames2)):
        raise ValueError(f"pair_join: shapes {tuple(s1.shape)}, "
                         f"{tuple(f1.shape)}, {tuple(s2.shape)}, "
                         f"{tuple(f2.shape)}, {tuple(m1.shape)}, "
                         f"{tuple(m2.shape)} for {len(frames1)} + "
                         f"{len(frames2)} frames")
    if not 1 <= len(pairs) <= _MAX_FRAME_PAIRS:
        raise ValueError(f"pair_join takes 1..{_MAX_FRAME_PAIRS} compatible "
                         f"frame pairs, got {len(pairs)}")
    dev = s1.device
    ins = [t.contiguous() for t in (s1, f1, s2, f2, m1, m2)]
    i32 = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
    i64 = [torch.empty(B, dtype=torch.int64, device=dev) for _ in range(6)]
    psum, best_s1, second = i32
    pf1, pf2, pbp1, pbp2, pa1, pa2 = i64
    if B:
        codes = [int(x) for p in pairs for x in p]
        arr = (ctypes.c_int * len(codes))(*codes)
        with _launching(dev) as stream:
            _check_rc(_lib().btbs_pair_join(
                *(t.data_ptr() for t in ins),
                *(t.data_ptr() for t in (psum, pf1, pf2, pbp1, pbp2, best_s1,
                                         pa1, pa2, second)),
                B, F1, F2, Kc, genome_len, e, min_insert, max_insert, arr,
                len(pairs), stream), "btbs_pair_join")
        LAUNCHES["pair_join"] += 1
    return (psum, pf1, pf2, pbp1, pbp2), best_s1, pa1, pa2, second


# ---- the compact candidate stage's flat buffer ----------------------------

_EXPAND_FRAMES = 64             # csrc/flat.cu kFrames: frames per block


def _block_bits(blocks) -> int:
    """The frames' blocks (0 fwd / 1 rc, one per frame) as csrc/flat.cu
    takes them: bit f is frame f's block."""
    if any(b not in (0, 1) for b in blocks):
        raise ValueError(f"expected blocks 0 / 1, got {blocks}")
    return sum(int(b) << f for f, b in enumerate(blocks))


def _blocks_tensor(blocks, dev):
    return torch.tensor(blocks, dtype=torch.int64, device=dev)


def flat_expand_ref(sp, ep, starts, lengths, blocks, max_occ: int, LB: int,
                    CAP: int):
    """Plain version: the seed order and the run-marker scatter + cummax
    expansion that models/aligner.candidate_grids_compact ran, with the
    lanes past n_used zeroed."""
    B, F, S = sp.shape
    R = B * F
    dev = sp.device

    def arange(n):
        return torch.arange(n, dtype=torch.int64, device=dev)

    # Each kept (frame, seed) owns a contiguous run of slots; one scatter
    # marks every run's start with its code and start slot, and a cummax
    # carries them across the packed buffer.
    cnt, sp, starts_l = aligner.order_seeds(sp, ep, starts,
                                            max_occ)             # B,F,S
    cum = torch.cumsum(cnt, dim=-1)
    offs = (cum - cnt).reshape(R, S)
    total = cum[..., -1]                                         # B,F
    frame_occ = torch.clamp(total, max=LB).reshape(R)
    frame_base = torch.cumsum(frame_occ, dim=0) - frame_occ
    overflow = total > LB
    gdrop = ((frame_base + frame_occ > CAP).reshape(B, F)
             & (frame_occ.reshape(B, F) > 0)).any(dim=-1)

    src_ok = (cnt.reshape(R, S) > 0) & (offs < frame_occ[:, None])
    gstart = frame_base[:, None] + offs                          # R,S
    # runs past the buffer are dropped: their slot is clamped into the
    # discarded slot CAP
    dst = torch.where(src_ok, gstart, CAP).reshape(-1).clamp(max=CAP)
    fs_code = (arange(R)[:, None] * S + arange(S)).reshape(-1)

    def run_marks(vals):
        buf = torch.zeros(CAP + 1, dtype=torch.int64, device=dev)
        buf = buf.scatter_reduce(0, dst, vals, reduce="amax")
        return torch.cummax(buf[:CAP], dim=0).values

    fs = run_marks(fs_code)
    gs = run_marks(gstart.reshape(-1))
    g = arange(CAP)
    n_used = frame_base[-1:] + frame_occ[-1:]
    ok = g < n_used                           # buffer is packed
    seed_tab = torch.stack(
        [sp.reshape(-1), starts_l.reshape(-1),
         lengths[:, None, None].expand(B, F, S).reshape(-1)], dim=-1)
    picked = seed_tab[fs]
    fidx = fs // S
    lanes = {"sa_row": wrap(picked[:, 0] + (g - gs)), "st": picked[:, 1],
             "len_b": picked[:, 2], "fidx": fidx,
             "blk": _blocks_tensor(blocks, dev)[fidx % F]}
    return {**{k: torch.where(ok, v, 0) for k, v in lanes.items()},
            "ok": ok, "n_used": n_used, "overflow": overflow,
            "gdrop": gdrop}


def flat_expand(sp, ep, starts, lengths, blocks, max_occ: int, LB: int,
                CAP: int):
    """The flat buffer of a candidate stage.  sp, ep: int64 [B, F, S] seed
    intervals (u32 values); starts: int64 broadcastable to them (the seeds'
    read positions); lengths: int64 [B]; blocks: the F frames' blocks (host
    ints, 0 fwd / 1 rc).  Per frame the kept seeds (0 < ep - sp <= max_occ)
    in ascending count order fill frame_occ = min(total, LB) slots, packed
    batch-wide into CAP slots.  Returns a dict: per slot sa_row, st (seed
    start), len_b (read length), fidx (frame row b * F + f), blk (int64
    [CAP]) and ok (bool [CAP]: the slot is filled; every field of an unfilled
    slot 0); n_used (int64 [1]: the slots the frames fill, on the device,
    possibly past CAP); overflow (bool [B, F]: total > LB); gdrop (bool [B]:
    a frame of the read lost slots past CAP).  One launch on the card
    (csrc/flat.cu btbs_flat_expand: two kernels)."""
    _require(torch.int64, sp=sp, ep=ep, starts=starts, lengths=lengths)
    if not _on_cuda(sp, ep, starts, lengths):
        return flat_expand_ref(sp, ep, starts, lengths, blocks, max_occ, LB,
                               CAP)
    if sp.dim() != 3 or ep.shape != sp.shape:
        raise ValueError(f"expected int64 [B, F, S] intervals, got "
                         f"{tuple(sp.shape)} and {tuple(ep.shape)}")
    B, F, S = sp.shape
    if tuple(lengths.shape) != (B,) or len(blocks) != F:
        raise ValueError(f"flat_expand: intervals {tuple(sp.shape)}, "
                         f"lengths {tuple(lengths.shape)}, {len(blocks)} "
                         f"blocks")
    dev = sp.device
    sp_c, ep_c, ln = sp.contiguous(), ep.contiguous(), lengths.contiguous()
    st_v = starts.expand(B, F, S)

    def i64(*shape):
        return torch.empty(shape, dtype=torch.int64, device=dev)

    scratch = i64(-(-B * F // _EXPAND_FRAMES))
    lanes = {k: i64(CAP) for k in ("sa_row", "st", "len_b", "fidx", "blk")}
    out = {**lanes, "ok": torch.empty(CAP, dtype=torch.bool, device=dev),
           "n_used": i64(1),
           "overflow": torch.empty((B, F), dtype=torch.bool, device=dev),
           "gdrop": torch.empty(B, dtype=torch.bool, device=dev)}
    with _launching(dev) as stream:
        _check_rc(_lib().btbs_flat_expand(
            sp_c.data_ptr(), ep_c.data_ptr(), st_v.data_ptr(), *st_v.stride(),
            ln.data_ptr(), B, F, S, max_occ, LB, CAP, _block_bits(blocks),
            scratch.data_ptr(), *(t.data_ptr() for t in out.values()),
            stream), "btbs_flat_expand")
    LAUNCHES["flat_expand"] += 1
    return out


def flat_dedup_ref(keyS, perm, len_b, overflow, blocks, Kc: int):
    """Plain version: the unique rank and Kc cap that
    models/aligner.candidate_grids_compact ran after its sort."""
    R = overflow.numel()
    F = len(blocks)
    dev = keyS.device
    rowS = keyS >> 32
    anchS = keyS & MASK
    lenS = len_b[perm]
    validS = rowS < R
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       keyS[1:] != keyS[:-1]])
    uniq = validS & first
    s_in = torch.cumsum(uniq.to(torch.int64), dim=0)
    s_excl = s_in - uniq.to(torch.int64)
    seg_first = torch.full((R + 1,), 1 << 30, dtype=torch.int64, device=dev)
    seg_first = seg_first.scatter_reduce(0, rowS, s_excl, reduce="amin")
    rank = s_excl - seg_first[torch.clamp(rowS, max=R)]
    nuniq = torch.zeros(R + 1, dtype=torch.int64, device=dev).scatter_add(
        0, rowS, uniq.to(torch.int64))
    keep = uniq & (rank < Kc)
    rowC = torch.clamp(rowS, max=R - 1)
    return {"keep": keep, "rank": rank,
            "cand": torch.where(keep, anchS, 0), "rowC": rowC,
            "blkS": _blocks_tensor(blocks, dev)[rowC % F], "lenS": lenS,
            "overflow": overflow | (nuniq[:R].reshape(overflow.shape) > Kc),
            "n_valid": validS.sum().reshape(1)}


def flat_dedup(keyS, perm, len_b, overflow, blocks, Kc: int):
    """The unique rank of the sorted flat buffer.  keyS: int64 [CAP] sorted
    keys row << 32 | anchor (row R = B * F for a lane without an anchor);
    perm: the sort's int64 permutation; len_b: int64 [CAP] read lengths of
    the unsorted lanes; overflow: bool [B, F] (flat_expand's); blocks: the F
    frames' blocks.  Returns a dict, per sorted lane (int64 [CAP] unless
    named): keep (bool: the first of its (row, anchor) and among the row's
    first Kc distinct anchors), rank (distinct anchors of its row before
    it), cand (its anchor where kept, else 0), rowC (its row, R - 1 past
    the rows), blkS (that row's block), lenS (its read length); overflow
    (bool [B, F]: also a row of more than Kc distinct anchors); n_valid
    (int64 [1]: the lanes of a row < R, on the device).  One launch on the
    card (csrc/flat.cu btbs_flat_dedup)."""
    _require(torch.int64, keyS=keyS, perm=perm, len_b=len_b)
    _require(torch.bool, overflow=overflow)
    if not _on_cuda(keyS, perm, len_b, overflow):
        return flat_dedup_ref(keyS, perm, len_b, overflow, blocks, Kc)
    CAP = keyS.shape[0]
    R = overflow.numel()
    F = len(blocks)
    if keyS.dim() != 1 or perm.shape != keyS.shape \
            or len_b.shape != keyS.shape or overflow.dim() != 2 \
            or overflow.shape[1] != F:
        raise ValueError(f"flat_dedup: keys {tuple(keyS.shape)}, perm "
                         f"{tuple(perm.shape)}, lengths {tuple(len_b.shape)},"
                         f" overflow {tuple(overflow.shape)}, {F} blocks")
    dev = keyS.device
    ins = [t.contiguous() for t in (keyS, perm, len_b, overflow)]

    def i64(n):
        return torch.empty(n, dtype=torch.int64, device=dev)

    out = {"keep": torch.empty(CAP, dtype=torch.bool, device=dev),
           **{k: i64(CAP) for k in ("rank", "cand", "rowC", "blkS", "lenS")},
           "overflow": torch.empty_like(ins[3]), "n_valid": i64(1)}
    with _launching(dev) as stream:
        _check_rc(_lib().btbs_flat_dedup(
            *(t.data_ptr() for t in ins), CAP, R, F, _block_bits(blocks), Kc,
            *(t.data_ptr() for t in out.values()), stream), "btbs_flat_dedup")
    LAUNCHES["flat_dedup"] += 1
    return out


def scatter_back_ref(keyS, keep, rank, score, lengths, blocks,
                     genome_len: int, e: int, Kc: int):
    """Plain version: the scatter back into the dense grids that
    models/aligner.candidate_grids_compact ran."""
    B = lengths.shape[0]
    F = len(blocks)
    R = B * F
    rowS = keyS >> 32
    anchS = keyS & MASK
    score = torch.where(keep & (score <= e), score, K.INF_SCORE)
    dst = torch.where(keep, rowS * Kc + rank, R * Kc)
    score_d = aligner.scatter_set(R * Kc + 1, K.INF_SCORE, torch.int32,
                                  dst, score).reshape(B, F, Kc)
    cand_d = aligner.scatter_set(R * Kc + 1, INVALID, torch.int64, dst,
                                 anchS).reshape(B, F, Kc)
    blk = _blocks_tensor(blocks, keyS.device)
    fwd = torch.where(blk[None, :, None] == K.BLOCK_FWD, cand_d,
                      wrap(genome_len - cand_d - lengths[:, None, None]))
    valid = score_d < K.INF_SCORE
    return {"score": score_d, "fwd": torch.where(valid, fwd, INVALID),
            "frame_a": torch.where(valid, cand_d, INVALID)}


def scatter_back(keyS, keep, rank, score, lengths, blocks, genome_len: int,
                 e: int, Kc: int):
    """The dense (B, F, Kc) grids of a candidate stage from its sorted flat
    lanes: keyS, rank int64 [CAP] and keep bool [CAP] (flat_dedup's), score
    int32 [CAP] (the verify's, per sorted lane), lengths int64 [B], blocks
    the F frames' blocks.  A kept lane with score <= e lands at (its row,
    its rank).  Returns {"score": int32 (INF_SCORE where nothing landed),
    "fwd": int64 fwd-genome anchor, "frame_a": int64 frame anchor (INVALID
    where the score is INF)}.  One launch on the card (csrc/flat.cu
    btbs_scatter_back)."""
    _require(torch.int64, keyS=keyS, rank=rank, lengths=lengths)
    _require(torch.bool, keep=keep)
    _require(torch.int32, score=score)
    if not _on_cuda(keyS, keep, rank, score, lengths):
        return scatter_back_ref(keyS, keep, rank, score, lengths, blocks,
                                genome_len, e, Kc)
    CAP = keyS.shape[0]
    B = lengths.shape[0]
    F = len(blocks)
    if keyS.dim() != 1 or any(t.shape != keyS.shape
                              for t in (keep, rank, score)) \
            or lengths.dim() != 1:
        raise ValueError(f"scatter_back: lanes {tuple(keyS.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    dev = keyS.device
    ins = [t.contiguous() for t in (keyS, keep, rank, score, lengths)]
    out = {"score": torch.empty((B, F, Kc), dtype=torch.int32, device=dev),
           "fwd": torch.empty((B, F, Kc), dtype=torch.int64, device=dev),
           "frame_a": torch.empty((B, F, Kc), dtype=torch.int64, device=dev)}
    with _launching(dev) as stream:
        _check_rc(_lib().btbs_scatter_back(
            *(t.data_ptr() for t in ins), CAP, B, F, Kc, _block_bits(blocks),
            genome_len, e, *(t.data_ptr() for t in out.values()), stream),
            "btbs_scatter_back")
    LAUNCHES["scatter_back"] += 1
    return out


def select_se_ref(grids, e: int):
    """Plain version: the staged order-free (score, fwd_anchor, block, pat)
    best/second reduction of the reference's select_se."""
    B = grids["score"].shape[0]
    sflat = grids["score"].reshape(B, -1)
    aflat = grids["fwd"].reshape(B, -1)
    frame_a = grids["frame_a"].reshape(B, -1)
    bpflat = grids["bp"].reshape(B, -1)

    s_best = sflat.amin(dim=-1)
    m1 = sflat == s_best[:, None]
    a_best = torch.where(m1, aflat, INVALID).amin(dim=-1)
    m2 = m1 & (aflat == a_best[:, None])
    bp_best = torch.where(m2, bpflat, 127).amin(dim=-1)
    m3 = m2 & (bpflat == bp_best[:, None])
    fa_best = torch.where(m3, frame_a, INVALID).amin(dim=-1)

    diff = torch.maximum(frame_a, fa_best[:, None]) - torch.minimum(
        frame_a, fa_best[:, None])
    distinct = (bpflat != bp_best[:, None]) | (diff > e)
    s_second = torch.where(distinct, sflat, K.INF_SCORE).amin(dim=-1)
    return {
        "best_score": s_best,
        "best_bp": bp_best,
        "best_anchor": fa_best,
        "second_score": s_second,
        "overflow": grids["overflow"],
        "gdrop": grids["gdrop"],
    }


def select_se(grids, e: int):
    """Order-free best / second per read over a candidate stage's (B, F, Kc)
    grids (score int32 in [0, INF_SCORE], fwd and frame_a int64 u32 values,
    bp int64 codes in [0, 255] at any strides): the lexicographic least
    (score, fwd, bp, frame_a), which the staged minima of the plain version
    pick, and the least score of a slot in another bp or more than e from
    its frame anchor.  Returns the reference's dict: best_score (int32),
    best_bp, best_anchor (int64), second_score (int32), and the grids'
    overflow and gdrop as they are.  One launch on the card (csrc/flat.cu
    btbs_select_se)."""
    score, fwd, frame_a, bp = (grids[k] for k in ("score", "fwd", "frame_a",
                                                  "bp"))
    _require(torch.int32, score=score)
    _require(torch.int64, fwd=fwd, frame_a=frame_a, bp=bp)
    if not _on_cuda(score, fwd, frame_a, bp):
        return select_se_ref(grids, e)
    if score.dim() != 3 or any(t.shape != score.shape
                               for t in (fwd, frame_a, bp)):
        raise ValueError(f"select_se: grids {tuple(score.shape)}, "
                         f"{tuple(fwd.shape)}, {tuple(frame_a.shape)}, "
                         f"{tuple(bp.shape)}")
    B, F, Kc = score.shape
    dev = score.device
    ins = [t.contiguous() for t in (score, fwd, frame_a)]
    out = {"best_score": torch.empty(B, dtype=torch.int32, device=dev),
           "best_bp": torch.empty(B, dtype=torch.int64, device=dev),
           "best_anchor": torch.empty(B, dtype=torch.int64, device=dev),
           "second_score": torch.empty(B, dtype=torch.int32, device=dev)}
    with _launching(dev) as stream:
        _check_rc(_lib().btbs_select_se(
            *(t.data_ptr() for t in ins), bp.data_ptr(), *bp.stride(), B, F,
            Kc, e, *(t.data_ptr() for t in out.values()), stream),
            "btbs_select_se")
    LAUNCHES["select_se"] += 1
    return {**out, "overflow": grids["overflow"], "gdrop": grids["gdrop"]}


# ---- table row gather --------------------------------------------------------

def gather_rows_ref(table, idx):
    """Plain version: table[idx] with idx clamped into the table."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def gather_rows(table, idx):
    """table int32 [R, W] (contiguous); idx int64 lanes of any shape
    (contiguous).  Returns int32 [..., W]: row idx of the table per lane,
    idx clamped into [0, R - 1]."""
    if isinstance(table, Shards):
        raise ValueError(f"table is split over {len(table.parts)} shards; "
                         f"gather_rows reads a whole table")
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
        with _launching(table.device) as stream:
            _check_rc(_lib().btbs_gather_rows(
                table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, L, W,
                stream), "btbs_gather_rows")
        LAUNCHES["gather_rows"] += 1
    return out


def gather_rows_shard_ref(table, idx, base: int):
    """Plain version: table[idx - base] where base <= idx < base + R, a
    zero row elsewhere."""
    R = table.shape[0]
    local = idx - base
    ok = (local >= 0) & (local < R)
    return torch.where(ok[..., None], table[local.clamp(0, R - 1)], 0)


def gather_rows_shard(table, idx, base: int):
    """One shard of a table split into row ranges: table int32 [R, W]
    (contiguous) holds the global rows [base, base + R); idx int64 lanes of
    any shape (contiguous), global row indices.  Returns int32 [..., W]: the
    row per lane inside the range, zeros outside."""
    if not _on_cuda(table, idx):
        return gather_rows_shard_ref(table, idx, base)
    if table.dtype != torch.int32 or table.dim() != 2 \
            or not table.is_contiguous() or table.shape[0] < 1 \
            or table.shape[1] < 1:
        raise ValueError(f"expected a contiguous int32 [R, W] shard, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int64 or not idx.is_contiguous():
        raise ValueError(f"expected contiguous int64 row indices, got "
                         f"{idx.dtype} {tuple(idx.shape)} strides "
                         f"{idx.stride()}")
    R, W = table.shape
    L = idx.numel()
    out = torch.empty((*idx.shape, W), dtype=torch.int32, device=table.device)
    if L:
        with _launching(table.device) as stream:
            _check_rc(_lib().btbs_gather_rows_shard(
                table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, L, W,
                base, stream), "btbs_gather_rows_shard")
        LAUNCHES["gather_rows_shard"] += 1
    return out


def gather_table(table, idx):
    """Rows of an int32 [R, W] table by int64 row index, on idx's device.
    A whole table: gather_rows (idx clamped into it).  A table split over
    cards (Shards, as the sharded index holds cp_rows, sa_samples and
    g_planes): one gather_rows_shard per shard on the shard's device, the
    partial rows brought to idx's device and summed there; every row lives
    on exactly one shard, so the sum is the row, and a row past the table
    is zero, as in the reference's sharded fetch."""
    if not isinstance(table, Shards):
        return gather_rows(table, idx)
    out = None
    for s, part in enumerate(table.parts):
        got = gather_rows_shard(part, idx.to(part.device),
                                s * table.rows).to(idx.device)
        out = got if out is None else out + got
    return out


# ---- FM-index step loops -------------------------------------------------------

def _check_index(dix) -> None:
    """Raise unless the FM kernels take the index's checkpoint rows and SA
    samples: both whole or both shard sets of as many parts (checked on any
    device), on the card contiguous int32 [R, 17] and [N]."""
    cp, sa = dix.cp_rows, dix.sa_samples
    if isinstance(cp, Shards) or isinstance(sa, Shards):
        if not (isinstance(cp, Shards) and isinstance(sa, Shards)) \
                or len(cp.parts) != len(sa.parts):
            raise ValueError("expected cp_rows and sa_samples both whole or "
                             "both split over as many shards")
        _check_shards(cp, "cp_rows")
        _check_shards(sa, "sa_samples")
        cp, sa = cp.parts[0], sa.parts[0]
    elif cp.device.type != "cuda":
        return
    if cp.dtype != torch.int32 or cp.dim() != 2 \
            or cp.shape[1] != K.CP_ROW_U32 or cp.shape[0] < 1 \
            or not cp.is_contiguous():
        raise ValueError(f"expected contiguous int32 [R, {K.CP_ROW_U32}] "
                         f"checkpoint rows, got {cp.dtype} {tuple(cp.shape)}")
    if sa.dtype != torch.int32 or sa.dim() != 1 or sa.numel() < 1 \
            or not sa.is_contiguous():
        raise ValueError(f"expected contiguous int32 [N] SA samples, got "
                         f"{sa.dtype} {tuple(sa.shape)}")


def _index_args(dix):
    """The device index as the FM kernels take it (csrc/fm.cu IndexArgs):
    the checkpoint rows and SA samples, whole or as shard sets, the per-block
    strides, cbase and n.  Checked."""
    _check_index(dix)
    cbase, n = dix.cbase, dix.n
    if cbase.dtype != torch.int64 or tuple(cbase.shape) != (2, K.CONV_ALPHA) \
            or not cbase.is_contiguous() or n.dtype != torch.int64 \
            or tuple(n.shape) != (2,) or not n.is_contiguous():
        raise ValueError("expected int64 cbase [2, 4] and n [2]")
    cp, cp_parts, nparts, R = _table_args(dix.cp_rows)
    sa, sa_parts, _, n_samples = _table_args(dix.sa_samples)
    return [cp, sa, cp_parts, sa_parts, nparts, R, n_samples, dix.rows_max,
            dix.samples_max, cbase.data_ptr(), n.data_ptr()]


def _pattern_args(patterns, lanes):
    """The (possibly broadcast) uint8 [..., m] patterns as the FM kernels
    address them: base pointer, the two inner lane sizes, the three lane
    strides and m.  No copy: a lane's row is found from the strides."""
    m = patterns.shape[-1]
    if len(lanes) > 3:
        raise ValueError(f"expected at most 3 lane dimensions, got {lanes}")
    p = patterns.expand(*lanes, m)
    if m > 1 and p.stride(-1) != 1:
        p = p.contiguous()
    size = [1] * (3 - len(lanes)) + list(lanes)
    stride = [0] * (3 - len(lanes)) + list(p.stride()[:-1])
    # the caller holds p until its launch is queued (it may be a copy)
    return p, [p.data_ptr(), size[1], size[2], *stride, m]


def _rows_ptr(rows_out, lanes, on_cuda: bool):
    """Pointer of the optional int32 [lanes] tensor that receives the number
    of checkpoint rows each lane fetched.  Only the kernels count rows."""
    if rows_out is None:
        return None
    if not on_cuda:
        raise ValueError("rows_out is filled by the CUDA kernels only")
    if rows_out.dtype != torch.int32 or rows_out.shape != lanes \
            or not rows_out.is_contiguous() or rows_out.device.type != "cuda":
        raise ValueError(f"expected a contiguous int32 CUDA {tuple(lanes)} "
                         f"rows_out, got {rows_out.dtype} "
                         f"{tuple(rows_out.shape)}")
    return rows_out.data_ptr()


def fm_search_ref(dix, block, patterns, starts, ends, sp0, ep0, k: int,
                  max_len: int, min_len: int = 0):
    """Plain version: the lockstep loops of ops/fm.search_lockstep."""
    return fm.search_lockstep(dix, block, patterns, starts, ends, sp0, ep0, k,
                              max_len, min_len)


def fm_search(dix, block, patterns, starts, ends, sp0, ep0, k: int,
              max_len: int, min_len: int = 0, rows_out=None):
    """Backward search of the pattern slices [start, end), one lane each:
    lanes at least k long start from (sp0, ep0) (the k-mer table's interval
    of their last k characters) at step k, shorter ones and every lane when
    k == 0 from (0, n) at step 0; a lane walks until min(length, max_len) or
    until its interval is empty.  block, starts, ends, sp0, ep0: int64 lanes
    (sp0 / ep0 None when k == 0); patterns uint8 [..., m] broadcastable over
    the lanes.  min_len is a hint for the plain version only; rows_out
    (here and in fm_extend / fm_locate): an int32 lane tensor that the kernel
    fills with the checkpoint rows each lane fetched, for measuring.
    Returns (sp, ep) u32 lanes as int64.  Here and in fm_extend /
    fm_locate, dix may be a sharded index (its tables index/device.Shards):
    the kernels then read the shard of each row themselves."""
    _check_index(dix)
    tensors = [dix.cp_rows, dix.cbase, block, patterns, starts, ends] \
        + ([sp0, ep0] if k else [])
    _require(torch.int64, block=block, starts=starts, ends=ends,
             **({"sp0": sp0, "ep0": ep0} if k else {}))
    _require(torch.uint8, patterns=patterns)
    if not _on_cuda(*tensors):
        _rows_ptr(rows_out, None, False)
        return fm_search_ref(dix, block, patterns, starts, ends, sp0, ep0, k,
                             max_len, min_len)
    lanes = torch.broadcast_shapes(block.shape, starts.shape, ends.shape,
                                   patterns.shape[:-1])
    b, s, e = (_lanes_i64(t, lanes) for t in (block, starts, ends))
    a0 = a1 = None
    if k:
        a0, a1 = _lanes_i64(sp0, lanes), _lanes_i64(ep0, lanes)
    pat, pat_args = _pattern_args(patterns, lanes)
    sp = torch.empty(lanes, dtype=torch.int64, device=b.device)
    ep = torch.empty(lanes, dtype=torch.int64, device=b.device)
    if b.numel():
        with _launching(b.device) as stream:
            _check_rc(_lib().btbs_fm_search(
                *_index_args(dix), *pat_args, b.data_ptr(), s.data_ptr(),
                e.data_ptr(), a0.data_ptr() if k else None,
                a1.data_ptr() if k else None, k, max_len, sp.data_ptr(),
                ep.data_ptr(), _rows_ptr(rows_out, lanes, True), b.numel(),
                stream), "btbs_fm_search")
        LAUNCHES["fm_search"] += 1
    return sp, ep


def fm_extend_ref(dix, block, patterns, starts, sp, ep, ext_max: int,
                  ext_occ: int):
    """Plain version: the lockstep loop of ops/fm.extend_lockstep."""
    return fm.extend_lockstep(dix, block, patterns, starts, sp, ep, ext_max,
                              ext_occ)


def fm_extend(dix, block, patterns, starts, sp, ep, ext_max: int,
              ext_occ: int, rows_out=None):
    """Adaptive seed extension, one lane each: while the interval holds more
    than ext_occ rows and starts > 0, prepend patterns[starts - 1], at most
    ext_max times, stopping before a step that would empty the interval.
    Returns (sp, ep, starts) as int64 lanes."""
    _check_index(dix)
    _require(torch.int64, block=block, starts=starts, sp=sp, ep=ep)
    _require(torch.uint8, patterns=patterns)
    if not _on_cuda(dix.cp_rows, dix.cbase, block, patterns, starts, sp,
                    ep):
        _rows_ptr(rows_out, None, False)
        return fm_extend_ref(dix, block, patterns, starts, sp, ep, ext_max,
                             ext_occ)
    if not 0 <= ext_occ <= 0xFFFFFFFF or ext_max < 0:
        raise ValueError(f"ext_max {ext_max} / ext_occ {ext_occ} out of range")
    lanes = torch.broadcast_shapes(block.shape, starts.shape, sp.shape,
                                   ep.shape, patterns.shape[:-1])
    b, s, a0, a1 = (_lanes_i64(t, lanes) for t in (block, starts, sp, ep))
    pat, pat_args = _pattern_args(patterns, lanes)
    outs = [torch.empty(lanes, dtype=torch.int64, device=b.device)
            for _ in range(3)]
    if b.numel():
        with _launching(b.device) as stream:
            _check_rc(_lib().btbs_fm_extend(
                *_index_args(dix), *pat_args, b.data_ptr(), s.data_ptr(),
                a0.data_ptr(), a1.data_ptr(), ext_max, ext_occ,
                *(o.data_ptr() for o in outs),
                _rows_ptr(rows_out, lanes, True), b.numel(), stream),
                "btbs_fm_extend")
        LAUNCHES["fm_extend"] += 1
    return tuple(outs)


def fm_locate_ref(dix, block, i, valid, n_lanes=None):
    """Plain version: the lockstep loop of ops/fm.locate_lockstep; lanes at
    or past n_lanes 0."""
    return _past_count(fm.locate_lockstep(dix, block, i, valid), n_lanes, 0)


def fm_locate(dix, block, i, valid, rows_out=None, n_lanes=None):
    """SA_block[i] per lane: at most dix.sa_rate LF steps to the next sampled
    suffix, then the sample plus the steps taken (u32).  block, i: int64
    lanes; valid: bool lanes (invalid lanes walk from position 0).  n_lanes:
    None, or an int64 [1] count on the lanes' device (1-D lanes): lanes at or
    past it give 0 and, on the card, load nothing (the flat buffer's fill,
    flat_expand's n_used)."""
    _check_index(dix)
    _require(torch.int64, block=block, i=i)
    _require(torch.bool, valid=valid)
    lanes = torch.broadcast_shapes(block.shape, i.shape, valid.shape)
    _check_count(n_lanes, lanes)
    counts = () if n_lanes is None else (n_lanes,)
    if not _on_cuda(dix.cp_rows, dix.sa_samples, dix.cbase, block, i,
                    valid, *counts):
        _rows_ptr(rows_out, None, False)
        return fm_locate_ref(dix, block, i, valid, n_lanes)
    b, pos = _lanes_i64(block, lanes), _lanes_i64(i, lanes)
    ok = valid.expand(lanes).contiguous()
    out = torch.empty(lanes, dtype=torch.int64, device=b.device)
    if b.numel():
        with _launching(b.device) as stream:
            _check_rc(_lib().btbs_fm_locate(
                *_index_args(dix), dix.sa_rate, b.data_ptr(), pos.data_ptr(),
                ok.data_ptr(), None if n_lanes is None else n_lanes.data_ptr(),
                out.data_ptr(), _rows_ptr(rows_out, lanes, True), b.numel(),
                stream), "btbs_fm_locate")
        LAUNCHES["fm_locate"] += 1
    return out


def dependent_load_chain(table, steps: int, seed: int = 1):
    """Measuring probe (not on the mapping path, not counted): one CUDA
    thread makes `steps` loads from the int32 table, each address computed
    from the word loaded before, the first from `seed` (a new seed walks
    other addresses, so a repeat does not find its words in the L2).  Its
    time over `steps` is the card's dependent-load latency on that table.
    Returns the int32 [1] result."""
    if table.device.type != "cuda" or table.dtype != torch.int32 \
            or not table.is_contiguous():
        raise ValueError("expected a contiguous int32 CUDA table")
    out = torch.empty(1, dtype=torch.int32, device=table.device)
    with _launching(table.device) as stream:
        _check_rc(_lib().btbs_dependent_load_chain(
            table.data_ptr(), table.numel(), steps, seed & 0xFFFFFFFF,
            out.data_ptr(), stream),
            "btbs_dependent_load_chain")
    return out
