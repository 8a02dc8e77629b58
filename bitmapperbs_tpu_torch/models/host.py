"""Host side of the single-end device pipeline (counterpart of the SE half of
bitmapperbs_tpu/models/host.py): batch prep, dispatch with a bounded
in-flight window, gdrop dense fallback, finalize to SAM records.

Finalize is the reference's jax-free models/pool.py (native C++ finalize
when libsais.so is built, numpy spec path otherwise), so a batch whose
(best, second) tuples equal the reference's gives byte-identical SAM.
"""
from __future__ import annotations

import numpy as np
import torch

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import BSIndex
from bitmapperbs_tpu.io.sam import SamRecord
from bitmapperbs_tpu.models.pool import (_finalize_se_task,
                                         _finalize_se_task_local)
from bitmapperbs_tpu_torch.index.device import DeviceIndex
from bitmapperbs_tpu_torch.models.aligner import map_batch_device

MAX_INFLIGHT = 3  # device batches dispatched ahead of host finalize


def prepare_batch(reads, m_pad: int, batch: int | None = None):
    """List of code arrays -> (uint8[B, m_pad] N-padded, int32[B] lengths)."""
    B = len(reads) if batch is None else batch
    arr = np.full((B, m_pad), K.N_CODE, dtype=np.uint8)
    lengths = np.full(B, m_pad, dtype=np.int32)  # dummy rows: full-length A
    arr[len(reads):] = K.A
    for i, r in enumerate(reads):
        r = np.asarray(r, dtype=np.uint8)
        if len(r) > m_pad:
            raise ValueError(f"read {i} longer than bucket {m_pad}")
        arr[i, :len(r)] = r
        lengths[i] = len(r)
    return arr, lengths


def _pad_rows(n: int, bs: int) -> int:
    """Batch-row count for n reads: full batches use bs; partial batches pad
    to the next power of two (bounded set of batch shapes)."""
    if n >= bs:
        return bs
    p = 1
    while p < n:
        p <<= 1
    return min(bs, p)


def _merge_where(sel, dense, fast):
    """Per-read merge of (possibly nested) host output dicts."""
    out = {}
    for k, v in fast.items():
        if isinstance(v, dict):
            out[k] = _merge_where(sel, dense[k], v)
        else:
            out[k] = np.where(sel, np.asarray(dense[k]), np.asarray(v))
    return out


def to_host(out: dict) -> dict:
    """Device output dict -> numpy dict in ONE device-to-host copy (the
    per-read vectors are stacked as int64 first)."""
    keys = list(out)
    host = torch.stack([out[k].to(torch.int64) for k in keys]).cpu().numpy()
    return {k: host[i].astype(bool) if out[k].dtype == torch.bool
            else host[i] for i, k in enumerate(keys)}


def _to_device(arr, lengths, device):
    return (torch.from_numpy(arr).to(device),
            torch.from_numpy(lengths).to(device))


def _gdrop_fallback_se(dix: DeviceIndex, cfg: AlignerConfig, arr, lengths,
                       out_np):
    """Re-run flat-buffer-overflow reads through the dense path.

    The compact pipeline drops candidate entries batch-dependently when its
    flat buffer fills; to keep output deterministic across batch
    compositions, every flagged read's result is replaced by the dense
    path's (the spec).  As in the reference, the whole batch is re-run and
    merged per read."""
    gdrop = out_np["gdrop"]
    if not (cfg.compact and gdrop.any()):
        return out_np
    dense = to_host(map_batch_device(dix, cfg.replace(compact=False),
                                     *_to_device(arr, lengths, dix.device),
                                     min_read_len=int(lengths.min())))
    return _merge_where(gdrop, dense, out_np)


def map_batch(idx: BSIndex, dix: DeviceIndex, cfg: AlignerConfig, reads,
              quals=None, qnames=None, stats=None,
              pool=None) -> list[SamRecord]:
    """End-to-end device mapping of a list of reads -> SAM records.

    Up to MAX_INFLIGHT batches are enqueued on the device ahead of the host
    finalize (map_batch_device does not sync); output order is preserved.
    stats: optional io.stats.MapStats (capacity-overflow reads are counted).
    pool: optional finalize pool (models.pool.make_finalize_pool)."""
    quals = quals or [""] * len(reads)
    qnames = qnames or [f"r{i}" for i in range(len(reads))]
    rc_ref = idx.genome.rc_codes()
    m_pad = cfg.read_len_bucket
    bs = cfg.batch_size
    out_recs: list[SamRecord] = []
    futures = []

    def drain(item):
        lo, n, arr, lengths, out = item
        out_np = _gdrop_fallback_se(dix, cfg, arr, lengths, to_host(out))
        if stats is not None:
            stats.overflow_reads += int(out_np["overflow"][:n].sum())
        task = (arr, lengths, n, quals[lo:lo + n], qnames[lo:lo + n], out_np)
        if pool is not None:
            futures.append(pool.apply_async(_finalize_se_task,
                                            (task + (cfg,),)))
        else:
            out_recs.extend(_finalize_se_task_local(idx, rc_ref, cfg, task))

    pending = []
    for lo in range(0, len(reads), bs):
        chunk = reads[lo:lo + bs]
        arr, lengths = prepare_batch(chunk, m_pad,
                                     batch=_pad_rows(len(chunk), bs))
        out = map_batch_device(dix, cfg,
                               *_to_device(arr, lengths, dix.device),
                               min_read_len=int(lengths.min()))
        pending.append((lo, len(chunk), arr, lengths, out))
        if len(pending) >= MAX_INFLIGHT:
            drain(pending.pop(0))
    for item in pending:
        drain(item)
    for fut in futures:   # ordered gather
        out_recs.extend(fut.get())
    return out_recs
