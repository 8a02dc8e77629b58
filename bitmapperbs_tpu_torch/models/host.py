"""Host side of the device pipelines (counterpart of
bitmapperbs_tpu/models/host.py): batch prep, dispatch with a bounded
in-flight window, gdrop dense fallback, finalize to SAM records, for
single-end reads (map_batch) and pairs (map_batch_pe), and the mapping loop
over a reader's batches that the CLI runs (map_reader_batches).

Reads and pairs take one path: map_batch and map_batch_pe call one body
(_map_units) with what the two differ in, a _Kind (the reads a unit holds,
the default names and qualities, the records' counters, the local
finalizer and the pool's task); the device and dense functions come from
one factory (_mappers), and the gdrop re-run and merge is one function.
task_slices decides how a batch's finalize reaches the pool's workers, and
map_grouped splits a call by per-read error budget and length bucket.

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

from typing import Callable, NamedTuple

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


def _gdrop_rerun(dense, cfg: AlignerConfig, host: dict, lo: int = -1
                 ) -> dict:
    """Re-run flat-buffer-overflow reads through the dense path.

    The compact pipeline drops candidate entries batch-dependently when its
    flat buffer fills; to keep output deterministic across batch
    compositions and meshes, every flagged read's (pair's) result is
    replaced by the dense path's (the spec).  As in the reference, the
    whole batch is re-run (dense(), on the host arrays) and merged per
    unit."""
    gdrop = host["gdrop"]
    if not (cfg.compact and gdrop.any()):
        return host
    with span("host.gdrop", lo):
        count("gdrop.batches")
        count("gdrop.reads", int(gdrop.sum()))
        return _merge_where(gdrop, to_host(dense()), host)


def _mappers(dix: DeviceIndex, cfg: AlignerConfig, mappers,
             graphs: bool = True, pe: bool = False):
    """(map_fn, dense_fn) on host arrays, single-end fn(arr, lengths,
    min_read_len) or, for pairs (`pe`), fn(a1, l1, a2, l2, min1, min2): the
    mesh's (parallel/shard.CliMappers) or one device's, whose eligible
    calls replay a CUDA graph when `graphs` is set."""
    if mappers is not None:
        return ((mappers.pe, mappers.pe_dense) if pe
                else (mappers.se, mappers.se_dense))
    mates = 2 if pe else 1

    def on(c):
        def fn(*args):          # each mate's (codes, lengths), then minima
            rows = args[0].shape[0]
            if graphs and device_graphs.eligible(dix, c, rows):
                graph = (device_graphs.map_batch_pe if pe
                         else device_graphs.map_batch)
                return graph(dix, c, *args)
            if REC.on:
                count(device_graphs.eager_reason(dix, c, rows, graphs))
            device = map_batch_pe_device if pe else map_batch_device
            tensors = [t for k in range(0, 2 * mates, 2)
                       for t in _to_device(args[k], args[k + 1], dix.device)]
            return device(dix, c, *tensors, *args[2 * mates:])
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


def _tally_se(raw: dict, host: dict, n: int, stats) -> None:
    """A batch of reads: its capacity-overflow reads after the gdrop
    merge."""
    if stats is not None:
        stats.overflow_reads += int(host["overflow"][:n].sum())


def _tally_pe(raw: dict, host: dict, n: int, stats) -> None:
    """A batch of pairs, from the device's outputs before the gdrop merge:
    the pairs, the pairs that rescue decided, and the pairs with a
    capacity overflow in either mate."""
    count("pe.pairs", n)
    if REC.on:
        count("pe.rescue_hits", int(np.count_nonzero(
            raw["resc_valid"][:n] & ~raw["pair_valid"][:n])))
    if stats is not None:
        stats.overflow_reads += int((raw["se1"]["overflow"][:n]
                                     | raw["se2"]["overflow"][:n]).sum())


class _Kind(NamedTuple):
    """What single-end reads and pairs differ in on the host."""
    mates: int                  # reads a unit holds: 1 a read, 2 a pair
    name: str                   # default name of unit i: f"{name}{i}"
    blank_quals: Callable       # n -> the qualities of n units given none
    tally: Callable             # (raw, merged, n, stats): counters, stats
    local: Callable             # (idx, rc_ref, cfg, task) -> records
    task: Callable              # the pool's task function


_SE = _Kind(1, "r", lambda n: [""] * n, _tally_se, _finalize_se_task_local,
            _finalize_se_task)
_PE = _Kind(2, "p", lambda n: None, _tally_pe,
            lambda idx, rc_ref, cfg, task: _assemble_pe_local(
                idx, rc_ref, cfg, *task),
            _assemble_pe_task)


def task_slices(n: int, workers: int, mates: int) -> list[tuple[int, int]]:
    """[start, end) of each finalize-pool task of a batch of n units: one
    task for a batch of reads (the CLI groups several batches a call); a
    batch of pairs, which a call maps alone, in at most `workers` nearly
    equal slices, since pairs are assembled independently and one task
    would keep all but one worker idle."""
    if mates == 1:
        return [(0, n)]
    step = max(1, -(-n // workers))
    return [(s, min(n, s + step)) for s in range(0, n, step)]


def _slice_tree(d: dict, s: int, e: int) -> dict:
    """Rows [s, e) of every array of a (nested) host output dict."""
    return {k: _slice_tree(v, s, e) if isinstance(v, dict) else v[s:e]
            for k, v in d.items()}


def _task_slice(task: tuple, s: int, e: int) -> tuple:
    """Units [s, e) of a finalize task (each mate's codes and lengths, n,
    qualities, names, host outputs); the whole task as it is."""
    *arrays, n, quals, qnames, host = task
    if (s, e) == (0, n):
        return task
    return (*(a[s:e] for a in arrays), e - s, quals[s:e] if quals else None,
            qnames[s:e], _slice_tree(host, s, e))


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


def _map_units(kind: _Kind, idx: BSIndex, dix: DeviceIndex,
               cfg: AlignerConfig, units, quals, qnames, stats, pool,
               mappers, graphs: bool) -> list[SamRecord] | list[SamLine]:
    """map_batch / map_batch_pe's body: units are reads or (read1, read2)
    pairs as `kind` says; kind.mates records a unit, in input order."""
    rc_ref = idx.genome.rc_codes()
    m_pad = cfg.read_len_bucket
    bs = cfg.batch_size
    rnd = mappers.batch_round if mappers is not None else 1
    map_fn, dense_fn = _mappers(dix, cfg, mappers, graphs, kind.mates == 2)

    def run(fn, planes):
        return fn(*(a for mate in planes for a in mate),
                  *(int(lengths.min()) for _, lengths in planes))

    def dispatch(lo):
        chunk = units[lo:lo + bs]
        B = _pad_rows(len(chunk), bs, rnd)
        with span("host.prepare", lo):
            planes = [prepare_batch(
                chunk if kind.mates == 1 else [u[k] for u in chunk], m_pad, B)
                for k in range(kind.mates)]
        with span("host.dispatch", lo):
            out = run(map_fn, planes)
        return len(chunk), planes, out

    def finish(lo, item):
        n, planes, out = item
        raw = to_host(out)
        host = _gdrop_rerun(lambda: run(dense_fn, planes), cfg, raw, lo)
        kind.tally(raw, host, n, stats)
        task = (*(a for mate in planes for a in mate), n,
                quals[lo:lo + n] if quals else kind.blank_quals(n),
                qnames[lo:lo + n] if qnames else
                [f"{kind.name}{lo + i}" for i in range(n)], host)
        if pool is None:
            with span("host.finalize", lo):
                return kind.local(idx, rc_ref, cfg, task)
        tasks = []
        for s, e in task_slices(n, pool._processes, kind.mates):
            with span("host.submit", lo + s):
                tasks.append((lo + s, pool.apply_async(
                    kind.task, (_task_slice(task, s, e)
                                + (cfg, REC.task_trace(lo + s)),))))
        return tuple(tasks)

    with span("host.call", call=True):
        return _pipelined(len(units), bs, dispatch, finish,
                          pe=kind.mates == 2)


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
    return _map_units(_SE, idx, dix, cfg, reads, quals, qnames, stats, pool,
                      mappers, graphs)


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
    batch's pairs in one slice per worker: task_slices),
    `mappers` maps over a mesh (pe / pe_dense), and `graphs` replays a CUDA
    graph per full batch on one card."""
    return _map_units(_PE, idx, dix, cfg, pairs, quals, qnames, stats, pool,
                      mappers, graphs)


def map_grouped(run, cfg: AlignerConfig, key, units, quals, qnames,
                mates: int = 1) -> list:
    """Partition a call's units (reads, or (read1, read2) pairs for
    mates=2) by per-read static-config key and map each group with its own
    config through run(c, units, quals, qnames); the records, `mates` a
    unit, are reassembled in input order.  key(length) -> (max_errors,
    read_len_bucket) of one read (cli._cfg_key); a pair's key is the max
    of its two mates' (equal-length mates -- the norm -- resolve exactly
    per read)."""
    if mates == 1:
        keys = [key(len(u)) for u in units]
    else:
        keys = []
        for a, b in units:
            ka, kb = key(len(a)), key(len(b))
            keys.append((max(ka[0], kb[0]), max(ka[1], kb[1])))
    uniq = sorted(set(keys))
    if len(uniq) == 1:
        b, bk = uniq[0]
        return run(cfg.replace(max_errors=b, read_len_bucket=bk),
                   units, quals, qnames)
    recs = [None] * (mates * len(units))
    for b, bk in uniq:
        sel = [i for i, v in enumerate(keys) if v == (b, bk)]
        sub = run(cfg.replace(max_errors=b, read_len_bucket=bk),
                  [units[i] for i in sel], [quals[i] for i in sel],
                  [qnames[i] for i in sel])
        for j, i in enumerate(sel):
            recs[mates * i:mates * (i + 1)] = sub[mates * j:mates * (j + 1)]
    return recs


def map_reader_batches(cfg: AlignerConfig, batches, run, key,
                       per_call: int = 1, keep=None):
    """The mapping loop over a reader's batches: io.fastq.ReadBatches of
    single-end reads, or (mate 1, mate 2) batches from io.fastq.read_pairs.

    Every `per_call` batches are mapped as one call: map_grouped under
    `key` through run(c, units, quals, qnames) (map_batch / map_batch_pe
    with their pool and mesh, or the oracle's mappers).  keep: optional
    filter(units, qnames, quals, start_record) -> the three lists of the
    units this process maps (parallel/multihost.HostShard.filter_batch).

    Yields per call, in input order, (records, reads, qnames, quals,
    cursor): one read, name and quality per record (a pair's mate 1, then
    mate 2) and the cursor that the call acknowledges, (next record, byte
    offset[, mate 2's byte offset]) after the last batch read.  A batch
    that `keep` empties is acknowledged by the next call when batches wait
    in the call's buffer, and otherwise at once, by a call of no records.
    """
    buf, cursor, mates = [], None, 1

    def call():
        units = [u for b in buf for u in b[0]]
        qnames = [q for b in buf for q in b[1]]
        quals = [q for b in buf for q in b[2]]
        buf.clear()
        recs = map_grouped(run, cfg, key, units, quals, qnames, mates)
        if mates == 1:
            return recs, units, qnames, quals, cursor
        return (recs, [r for p in units for r in p],
                [q for q in qnames for _ in (0, 1)],
                [q for p in quals for q in p], cursor)

    for batch in batches:
        if isinstance(batch, tuple):
            mates, (b1, b2) = 2, batch
            units = list(zip(b1.codes, b2.codes))
            qnames, quals = b1.qnames, list(zip(b1.quals, b2.quals))
            cursor = (b1.start_record + len(b1), b1.end_offset,
                      b2.end_offset)
        else:
            b1, units, qnames, quals = (batch, batch.codes, batch.qnames,
                                        batch.quals)
            cursor = (b1.start_record + len(b1), b1.end_offset)
        if keep is not None:
            # the cursor advances by the unfiltered batch: shard ownership
            # is by global record index, so record indices and byte
            # offsets stay aligned across a resume
            units, qnames, quals = keep(units, qnames, quals,
                                        b1.start_record)
            if not units:
                if not buf:
                    yield [], [], [], [], cursor
                continue
        buf.append((units, qnames, quals))
        if len(buf) >= per_call:
            yield call()
    if buf:
        yield call()
