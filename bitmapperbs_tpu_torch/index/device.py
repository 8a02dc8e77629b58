"""Device-resident index tensors (counterpart of
bitmapperbs_tpu/index/device.py).

The same flat layouts as the reference: the two FM blocks padded to a common
row count and stacked, so one gather indexed by `block * rows_max + row`
serves lanes in either block; the original genome as bit-packed planes in
both orientations, one row of [b0, b1, nmask] per 32-position word.

The large tables (cp_rows, sa_samples, g_planes, klt) are int32 tensors
holding the u32 bits (ops/u32.py); callers widen after each gather.  The
small ones (cbase, n) are int64.

A sharded index (upload_index_sharded, the counterpart of the reference's
parallel/shard.upload_index_sharded) holds cp_rows, sa_samples and g_planes
as `Shards`: equal row ranges of the padded table, one per card of an index
group.  cbase, n and klt stay whole tensors on the group's first card, where
the lanes live.  The fused kernels (ops/kernels.py) read a shard set
themselves, each row from the shard that holds it, through peer access
where a shard sits on another card; the plain versions read it through
ops/kernels.gather_table.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.index.build import BSIndex
from bitmapperbs_tpu_torch.ops.u32 import u32_to_i32_np

PLANES_CACHE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Shards:
    """One table split into equal row ranges: parts[s], on its own device,
    holds the global rows [s * rows, (s + 1) * rows) (the reference's
    P(idx_axis) sharding); a row outside them reads as zeros.  Not a
    tensor: ops/kernels' FM, gathering-verify and rescue wrappers take it
    (at most kernels.MAX_SHARDS parts of one shape), and gather_table reads
    it for the plain versions."""
    parts: tuple[torch.Tensor, ...]

    @property
    def rows(self) -> int:
        return self.parts[0].shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.parts)


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    cp_rows: torch.Tensor | Shards     # int32 bits [2 * rows_max, CP_ROW_U32]
    cbase: torch.Tensor                # int64 [2, CONV_ALPHA]
    sa_samples: torch.Tensor | Shards  # int32 bits [2 * samples_max]
    n: torch.Tensor                    # int64 [2] text lengths (+ sentinel)
    g_planes: torch.Tensor | Shards    # int32 bits [2 * g_words, 3]
    klt: torch.Tensor                  # int32 bits [2 * 3^klt_k, 2]
    rows_max: int
    genome_len: int
    samples_max: int
    sa_rate: int = K.DEFAULT_SA_RATE
    klt_k: int = 0
    g_words: int = 0
    # the CUDA graphs of this index's device calls by key (models/graphs.py):
    # they read its tables, so they live and go with it
    graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def sharded(self) -> bool:
        return isinstance(self.cp_rows, Shards)

    @property
    def device(self) -> torch.device:
        """Where the lanes live: the device of the whole tables (sharded:
        the index group's first card)."""
        return self.cbase.device

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes if isinstance(t, Shards)
                   else t.numel() * t.element_size() for t in
                   (self.cp_rows, self.cbase, self.sa_samples, self.n,
                    self.g_planes, self.klt))


# ---- genome-plane cache (copied from the reference: numpy only) -----------

def _planes_cache_path(idx: BSIndex) -> str | None:
    """Derived genome-plane cache next to the artifact, keyed by the genome
    hash; the file format is the reference's, so both packages share it."""
    if idx.source_prefix is None:
        return None
    sha = idx.meta.get("genome_sha256", "")[:16]
    if not sha:
        return None
    d = os.path.dirname(os.path.abspath(idx.source_prefix))
    return os.path.join(d, f"gplanes_{sha}.v{PLANES_CACHE_VERSION}.bin")


def _device_layout_planes(genome) -> np.ndarray:
    """Genome -> uint32[2 * (words+1), 3] in the upload layout: a leading
    zero word per orientation (window_planes biases starts by +32 so wrapped
    negative starts resolve) and plane-interleaved rows."""
    planes = genome.packed_planes()
    words = len(planes["g0"])
    gp = np.zeros((2, words + 1, 3), dtype=np.uint32)
    for oi, pref in enumerate(("g", "r")):
        for pi, suf in enumerate(("0", "1", "n")):
            gp[oi, 1:, pi] = planes[pref + suf]
    return gp.reshape(2 * (words + 1), 3)


def _load_or_build_planes(idx: BSIndex) -> np.ndarray:
    path = _planes_cache_path(idx)
    words = (idx.genome.length + 31) // 32
    n_rows = 2 * (words + 1)
    if path is not None:
        if not os.path.exists(path):
            gp = _device_layout_planes(idx.genome)
            tmp = path + f".tmp.{os.getpid()}"
            gp.tofile(tmp)
            os.replace(tmp, path)
        gp = np.memmap(path, dtype=np.uint32, mode="r")
        if gp.size == n_rows * 3:
            return gp.reshape(n_rows, 3)
        # stale/foreign cache (size mismatch): rebuild in RAM, don't trust it
    return _device_layout_planes(idx.genome)


# ---- upload ----------------------------------------------------------------

def _stacked(parts, shape) -> np.ndarray:
    """Row-stitch (row_offset, uint32 array) parts into one zeroed array."""
    out = np.zeros(shape, dtype=np.uint32)
    for off, a in parts:
        out[off:off + a.shape[0]] = a
    return out


def from_arrays(arrays: dict[str, np.ndarray], device=None,
                **static) -> DeviceIndex:
    """uint32 host arrays in the reference's DeviceIndex layout (e.g. the JAX
    DeviceIndex's arrays fetched as numpy) -> the port's DeviceIndex.

    static: rows_max, genome_len, samples_max, sa_rate, klt_k, g_words."""
    return DeviceIndex(
        **{k: _big(arrays[k], device)
           for k in ("cp_rows", "sa_samples", "g_planes", "klt")},
        **{k: _small(arrays[k], device) for k in ("cbase", "n")}, **static)


def _big(a: np.ndarray, device) -> torch.Tensor:
    """uint32 table -> int32 tensor of its bits; copies on the host only
    when not already writable C-order uint32."""
    a = np.require(a, np.uint32, ["C", "W"])
    return torch.from_numpy(u32_to_i32_np(a)).to(device)


def _small(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.require(a, np.int64, ["C", "W"])).to(device)


def _host_arrays(idx: BSIndex) -> tuple[dict, dict]:
    """Host BSIndex -> (uint32 arrays in the DeviceIndex layout, static
    fields)."""
    rows_max = max(b.cp_rows.shape[0] for b in idx.blocks)
    smax = max(max(len(b.sa_samples) for b in idx.blocks), 1)
    klt_k = idx.blocks[0].klt_k
    assert all(b.klt_k == klt_k for b in idx.blocks)
    gp = _load_or_build_planes(idx)
    arrays = {
        "cp_rows": _stacked([(i * rows_max, b.cp_rows)
                             for i, b in enumerate(idx.blocks)],
                            (2 * rows_max, K.CP_ROW_U32)),
        "cbase": np.stack([b.cbase for b in idx.blocks]),
        "sa_samples": _stacked([(i * smax, b.sa_samples)
                                for i, b in enumerate(idx.blocks)],
                               (2 * smax,)),
        "n": np.array([b.n for b in idx.blocks], dtype=np.uint32),
        "g_planes": gp,
        "klt": np.stack([b.klt for b in idx.blocks]).reshape(
            2 * 3 ** klt_k, 2),
    }
    return arrays, dict(rows_max=rows_max, genome_len=idx.genome.length,
                        samples_max=smax, sa_rate=idx.blocks[0].sa_rate,
                        klt_k=klt_k, g_words=gp.shape[0] // 2)


def upload_index(idx: BSIndex, device=None) -> DeviceIndex:
    """Host BSIndex -> device tensors (replicated on one device)."""
    arrays, static = _host_arrays(idx)
    return from_arrays(arrays, device, **static)


def _per_block_pad(flat2: np.ndarray, stride: int,
                   new_stride: int) -> np.ndarray:
    """[2 * stride, ...] -> [2 * new_stride, ...], block offsets at
    multiples of new_stride, the rows between them zero."""
    out = np.zeros((2 * new_stride, *flat2.shape[1:]), flat2.dtype)
    out[:stride] = flat2[:stride]
    out[new_stride:new_stride + stride] = flat2[stride:2 * stride]
    return out


def upload_index_sharded(idx: BSIndex, devices) -> DeviceIndex:
    """Host BSIndex -> a DeviceIndex whose cp_rows, sa_samples and g_planes
    are split into len(devices) equal row ranges, shard s on devices[s]
    (devices may repeat).  As the reference's: cp_rows and sa_samples are
    padded per block, each block's rows to a multiple of the shard count,
    and rows_max / samples_max become the padded strides, so every
    `block * rows_max + row` addresses the same row; g_planes is padded at
    its end (g_words, the per-block offset, is unchanged).  cbase, n and klt
    are whole, on devices[0].  The kernels launched on devices[0] read the
    other cards' shards: peer access is enabled first, and a pair of cards
    without it raises ValueError naming both (ops/kernels.enable_peer_access)."""
    from bitmapperbs_tpu_torch.ops import kernels   # imports this module

    devices = [torch.device(d) for d in devices]
    kernels.enable_peer_access(devices[0], devices[1:])
    ns = len(devices)
    arrays, static = _host_arrays(idx)
    rows_max = -(-static["rows_max"] // ns) * ns
    smax = -(-static["samples_max"] // ns) * ns
    gp = np.asarray(arrays["g_planes"])
    tables = {
        "cp_rows": _per_block_pad(arrays["cp_rows"], static["rows_max"],
                                  rows_max),
        "sa_samples": _per_block_pad(arrays["sa_samples"],
                                     static["samples_max"], smax),
        "g_planes": np.concatenate(
            [gp, np.zeros((-gp.shape[0] % ns, 3), gp.dtype)]),
    }

    def split(name):
        a, rows = tables[name], tables[name].shape[0] // ns
        return Shards(tuple(_big(a[s * rows:(s + 1) * rows], dev)
                            for s, dev in enumerate(devices)))

    return DeviceIndex(
        cp_rows=split("cp_rows"), cbase=_small(arrays["cbase"], devices[0]),
        sa_samples=split("sa_samples"), n=_small(arrays["n"], devices[0]),
        g_planes=split("g_planes"), klt=_big(arrays["klt"], devices[0]),
        **{**static, "rows_max": rows_max, "samples_max": smax})
