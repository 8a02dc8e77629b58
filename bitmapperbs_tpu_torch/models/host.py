"""Host side of the device pipelines (counterpart of
bitmapperbs_tpu/models/host.py): batch prep, dispatch with a bounded
in-flight window, gdrop dense fallback, finalize to SAM records, for
single-end reads (map_batch) and pairs (map_batch_pe).

Finalize and PE assembly are models/pool.py (native C++ finalize when
index/sais_native/libsais.so is built, numpy spec path otherwise), kept
equal to the reference's, so a batch whose device tensors equal the
reference's gives byte-identical SAM.

On one card a full batch's device call replays a CUDA graph
(models/graphs.py, the counterpart of the reference's jax.jit) at any
flat_chunks; tail batches, the gdrop dense re-run, CPU tensors and the
mesh mappers stay eager, and `graphs=False` keeps every call eager.

A pool task's records come back as SAM text (io/sam.SamText, the text in a
file beside the pool's genome copies: models/pool._ship), which the main
thread reads and splits into io/sam.SamLines: with a pool the calls return
SamLines, without one SamRecords; writers and MapStats take either.

The loop is traced by utils/profiling's recorder when it is on (the CLI's
--profile run; a benchmark's window): `host.call` per call, per batch
`host.prepare`, `host.dispatch`, `host.d2h`, `host.gdrop`, `host.submit` /
`host.finalize`, `host.finalize_wait` and `host.unpack`, the pool workers'
`pool.task`, the eager calls and gdrop batches counted, the records and
characters of SAM text that came back from the pool, the G->A records with
an indel, and for pairs the pairs, rescues, proper-pair records and records
whose mate is unmapped.
"""
from __future__ import annotations

import numpy as np
import torch

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.config import AlignerConfig
from bitmapperbs_tpu_torch.index.build import BSIndex
from bitmapperbs_tpu_torch.index.device import DeviceIndex
from bitmapperbs_tpu_torch.io.sam import SamLine, SamRecord
from bitmapperbs_tpu_torch.models import graphs as device_graphs
from bitmapperbs_tpu_torch.models.aligner import map_batch_device
from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device
from bitmapperbs_tpu_torch.models.pool import (_assemble_pe_local,
                                               _assemble_pe_task,
                                               _finalize_se_task,
                                               _finalize_se_task_local,
                                               ga_gapped_records, receive)
from bitmapperbs_tpu_torch.utils.profiling import REC, count, span

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


def _pad_rows(n: int, bs: int, rnd: int = 1) -> int:
    """Batch-row count for n reads: full batches use bs; partial batches pad
    to the next power of two (bounded set of batch shapes); either rounded
    up to a multiple of rnd (the mesh's data slices)."""
    if n < bs:
        p = 1
        while p < n:
            p <<= 1
        n = min(bs, p)
    else:
        n = bs
    return -(-n // rnd) * rnd


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
    """Device output dict (nested dicts allowed, as PE's se1/se2) -> numpy
    dict of the same shape in ONE device-to-host copy (the per-read vectors
    are stacked as int64 first); span `host.d2h`."""
    with span("host.d2h"):
        leaves = []

        def flatten(d, path):
            for k, v in d.items():
                if isinstance(v, dict):
                    flatten(v, path + (k,))
                else:
                    leaves.append((path + (k,), v))

        flatten(out, ())
        host = torch.stack([v.to(torch.int64)
                            for _, v in leaves]).cpu().numpy()
        res: dict = {}
        for row, (path, v) in zip(host, leaves):
            d = res
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = row.astype(bool) if v.dtype == torch.bool else row
        return res


def _to_device(arr, lengths, device):
    return (torch.from_numpy(arr).to(device),
            torch.from_numpy(lengths).to(device))


def _gdrop_fallback_se(dense_fn, cfg: AlignerConfig, arr, lengths, out_np,
                       lo: int = -1):
    """Re-run flat-buffer-overflow reads through the dense path.

    The compact pipeline drops candidate entries batch-dependently when its
    flat buffer fills; to keep output deterministic across batch
    compositions and meshes, every flagged read's result is replaced by the
    dense path's (the spec).  As in the reference, the whole batch is re-run
    (dense_fn, on the host arrays) and merged per read."""
    gdrop = out_np["gdrop"]
    if not (cfg.compact and gdrop.any()):
        return out_np
    with span("host.gdrop", lo):
        count("gdrop.batches")
        count("gdrop.reads", int(gdrop.sum()))
        dense = to_host(dense_fn(arr, lengths, int(lengths.min())))
        return _merge_where(gdrop, dense, out_np)


def _se_mappers(dix: DeviceIndex, cfg: AlignerConfig, mappers,
                graphs: bool = True):
    """(map_fn, dense_fn), each fn(arr, lengths, min_read_len) on host
    arrays: the mesh's (parallel/shard.CliMappers) or one device's, whose
    eligible calls replay a CUDA graph when `graphs` is set."""
    if mappers is not None:
        return mappers.se, mappers.se_dense

    def on(c):
        def fn(arr, lengths, mn):
            if graphs and device_graphs.eligible(dix, c, arr.shape[0]):
                return device_graphs.map_batch(dix, c, arr, lengths, mn)
            if REC.on:
                count(device_graphs.eager_reason(dix, c, arr.shape[0],
                                                 graphs))
            return map_batch_device(dix, c,
                                    *_to_device(arr, lengths, dix.device),
                                    min_read_len=mn)
        return fn
    return on(cfg), on(cfg.replace(compact=False))


def _count_records(flag: np.ndarray, ga: int, pe: bool) -> None:
    """The counters of one part's records, from their FLAG column and the
    count of G->A records with an indel: for pairs (`pe`), the records of a
    proper pair (0x2) and those whose mate is unmapped (0x8)."""
    count("sam.ga_gapped_records", ga)
    if pe:
        count("pe.proper_records",
              int(np.count_nonzero(flag & K.FLAG_PROPER)))
        count("pe.mate_unmapped_records",
              int(np.count_nonzero(flag & K.FLAG_MATE_UNMAPPED)))


def _slices(n: int, k: int) -> list[tuple[int, int]]:
    """[start, end) of at most k contiguous, nearly equal slices of n."""
    step = max(1, -(-n // k))
    return [(s, min(n, s + step)) for s in range(0, n, step)]


def _slice_tree(d: dict, s: int, e: int) -> dict:
    """Rows [s, e) of every array of a (nested) host output dict."""
    return {k: _slice_tree(v, s, e) if isinstance(v, dict) else v[s:e]
            for k, v in d.items()}


def _pipelined(n: int, bs: int, dispatch, finish, pe: bool = False
               ) -> list[SamRecord] | list[SamLine]:
    """Batches start at each lo in range(0, n, bs): dispatch(lo) enqueues
    one on the device (no sync) up to MAX_INFLIGHT batches ahead of
    finish(lo, item), which takes dispatch's result and returns its
    records, or a tuple of (first read, the finalize pool's AsyncResult)
    per pool task of the batch, whose results, (the records shipped as
    SAM text, pool.task span or None, sam.ga_gapped_records or None), are
    received and unpacked as SamLines in that order.  Returns all records
    in input order; with the recorder on, counts them (`pe`: the pairs'
    FLAG counters too)."""
    parts, pending = [], []
    for lo in range(0, n, bs):
        pending.append((lo, dispatch(lo)))
        if len(pending) >= MAX_INFLIGHT:
            lo0, item = pending.pop(0)
            parts.append((lo0, finish(lo0, item)))
    parts.extend((lo, finish(lo, item)) for lo, item in pending)
    out: list = []
    for _, part in parts:   # ordered gather
        if not isinstance(part, tuple):     # finalized in this process
            if REC.on:
                _count_records(np.array([r.flag for r in part], np.int32),
                               ga_gapped_records(part), pe)
            out.extend(part)
            continue
        for lo, result in part:
            with span("host.finalize_wait", lo):
                shipped, task_span, ga = result.get()
            REC.add(task_span)
            with span("host.unpack", lo):
                text = receive(shipped)
                recs = text.lines()
                if REC.on:
                    count("pool.text_records", len(recs))
                    count("pool.text_bytes", len(text.text))
                    _count_records(text.flag, ga or 0, pe)
            out.extend(recs)
    return out


def map_batch(idx: BSIndex, dix: DeviceIndex, cfg: AlignerConfig, reads,
              quals=None, qnames=None, stats=None, pool=None,
              mappers=None, graphs: bool = True
              ) -> list[SamRecord] | list[SamLine]:
    """End-to-end device mapping of a list of reads -> SAM records
    (SamLines when `pool` finalized them).

    Up to MAX_INFLIGHT batches are enqueued on the device ahead of the host
    finalize (map_batch_device does not sync); output order is preserved.
    stats: optional io.stats.MapStats (capacity-overflow reads are counted).
    pool: optional finalize pool (models.pool.make_finalize_pool).
    mappers: optional parallel.shard.CliMappers: batches map over its mesh
    (rows rounded up to a multiple of its data slices) instead of on dix,
    which is then unused.  graphs: replay a CUDA graph per full batch on
    one card (models/graphs.py); False keeps every device call eager.  The
    records do not depend on it."""
    quals = quals or [""] * len(reads)
    qnames = qnames or [f"r{i}" for i in range(len(reads))]
    rc_ref = idx.genome.rc_codes()
    m_pad = cfg.read_len_bucket
    bs = cfg.batch_size
    rnd = mappers.batch_round if mappers is not None else 1
    map_fn, dense_fn = _se_mappers(dix, cfg, mappers, graphs)

    def dispatch(lo):
        chunk = reads[lo:lo + bs]
        with span("host.prepare", lo):
            arr, lengths = prepare_batch(chunk, m_pad,
                                         batch=_pad_rows(len(chunk), bs, rnd))
        with span("host.dispatch", lo):
            out = map_fn(arr, lengths, int(lengths.min()))
        return len(chunk), arr, lengths, out

    def finish(lo, item):
        n, arr, lengths, out = item
        out_np = _gdrop_fallback_se(dense_fn, cfg, arr, lengths,
                                    to_host(out), lo)
        if stats is not None:
            stats.overflow_reads += int(out_np["overflow"][:n].sum())
        task = (arr, lengths, n, quals[lo:lo + n], qnames[lo:lo + n], out_np)
        if pool is not None:
            with span("host.submit", lo):
                return ((lo, pool.apply_async(
                    _finalize_se_task, (task + (cfg, REC.task_trace(lo)),))),)
        with span("host.finalize", lo):
            return _finalize_se_task_local(idx, rc_ref, cfg, task)

    with span("host.call", call=True):
        return _pipelined(len(reads), bs, dispatch, finish)


def _pe_mappers(dix: DeviceIndex, cfg: AlignerConfig, mappers,
                graphs: bool = True):
    """PE analogue of _se_mappers: fn(a1, l1, a2, l2, min1, min2)."""
    if mappers is not None:
        return mappers.pe, mappers.pe_dense

    def on(c):
        def fn(a1, l1, a2, l2, mn1, mn2):
            if graphs and device_graphs.eligible(dix, c, a1.shape[0]):
                return device_graphs.map_batch_pe(dix, c, a1, l1, a2, l2,
                                                  mn1, mn2)
            if REC.on:
                count(device_graphs.eager_reason(dix, c, a1.shape[0],
                                                 graphs))
            return map_batch_pe_device(
                dix, c, *_to_device(a1, l1, dix.device),
                *_to_device(a2, l2, dix.device), min_read_len1=mn1,
                min_read_len2=mn2)
        return fn
    return on(cfg), on(cfg.replace(compact=False))


def map_batch_pe(idx: BSIndex, dix: DeviceIndex, cfg: AlignerConfig, pairs,
                 quals=None, qnames=None, stats=None, pool=None,
                 mappers=None, graphs: bool = True
                 ) -> list[SamRecord] | list[SamLine]:
    """End-to-end device PE mapping of (read1, read2) code-array pairs ->
    SAM records (SamLines when `pool` assembled them), two per pair, in
    input order.

    quals: optional per-pair (qual1, qual2); qnames: optional per-pair
    names (default p<i>).  As map_batch: up to MAX_INFLIGHT batches in
    flight, one D2H copy per batch, a whole-batch dense re-run merged per
    pair when any pair has gdrop, stats.overflow_reads counts pairs with a
    capacity overflow in either mate, `pool` fans the assembly out (a
    batch's pairs in one slice per worker),
    `mappers` maps over a mesh (pe / pe_dense), and `graphs` replays a CUDA
    graph per full batch on one card."""
    m_pad = cfg.read_len_bucket
    bs = cfg.batch_size
    rc_ref = idx.genome.rc_codes()
    rnd = mappers.batch_round if mappers is not None else 1
    map_fn, dense_fn = _pe_mappers(dix, cfg, mappers, graphs)

    def run(fn, a1, l1, a2, l2):
        return fn(a1, l1, a2, l2, int(l1.min()), int(l2.min()))

    def dispatch(lo):
        chunk = pairs[lo:lo + bs]
        B = _pad_rows(len(chunk), bs, rnd)
        with span("host.prepare", lo):
            a1, l1 = prepare_batch([p[0] for p in chunk], m_pad, B)
            a2, l2 = prepare_batch([p[1] for p in chunk], m_pad, B)
        with span("host.dispatch", lo):
            out = run(map_fn, a1, l1, a2, l2)
        return len(chunk), a1, l1, a2, l2, out

    def finish(lo, item):
        n, a1, l1, a2, l2, out = item
        host = to_host(out)
        count("pe.pairs", n)
        if REC.on:
            count("pe.rescue_hits", int(np.count_nonzero(
                host["resc_valid"][:n] & ~host["pair_valid"][:n])))
        if stats is not None:
            stats.overflow_reads += int((host["se1"]["overflow"][:n]
                                         | host["se2"]["overflow"][:n]).sum())
        if cfg.compact and host["gdrop"].any():
            with span("host.gdrop", lo):
                count("gdrop.batches")
                count("gdrop.reads", int(host["gdrop"].sum()))
                dense = to_host(run(dense_fn, a1, l1, a2, l2))
                host = _merge_where(host["gdrop"], dense, host)
        qs = quals[lo:lo + n] if quals else None
        qn = (qnames[lo:lo + n] if qnames else
              [f"p{lo + i}" for i in range(n)])
        if pool is None:
            with span("host.finalize", lo):
                return _assemble_pe_local(idx, rc_ref, cfg, a1, l1, a2, l2,
                                          n, qs, qn, host)
        # one call maps one batch of pairs: its assembly is split over the
        # pool's workers (pairs are assembled independently), where one
        # task a batch would keep all but one worker idle
        tasks = []
        for s, e in _slices(n, pool._processes):
            with span("host.submit", lo + s):
                task = (a1[s:e], l1[s:e], a2[s:e], l2[s:e], e - s,
                        qs[s:e] if qs else None, qn[s:e],
                        _slice_tree(host, s, e))
                tasks.append((lo + s, pool.apply_async(
                    _assemble_pe_task,
                    (task + (cfg, REC.task_trace(lo + s)),))))
        return tuple(tasks)

    with span("host.call", call=True):
        return _pipelined(len(pairs), bs, dispatch, finish, pe=True)
