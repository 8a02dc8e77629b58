"""Tracing of the port (counterpart of bitmapperbs_tpu/utils/profiling.py):
spans and counters of the host loop, kept in memory, and the torch.profiler
trace of the CLI's `--profile DIR`.

The recorder, `REC`, is one per process, as the profiler it sits beside:
code anywhere in the host loop opens a span with `span(name)` and bumps a
counter with `count(name)`; `REC.start()` switches it on (emptied),
`REC.stop()` off, and `REC.snapshot()` hands out what it holds.  Off, the
default, a span is one flag test that returns a shared null context (no
clock read, no allocation) and a counter one flag test.  No span is opened
per record: per-record work is timed by the span around its loop.

A span (`Span`) keeps its name, start and end (`time.perf_counter_ns`),
its id and its parent's (the innermost span open in the same thread, 0 for
none), the id of the models/host.map_batch / map_batch_pe call it belongs
to (`host.call` opens a new one; the spans inside it, and the pool tasks it
submits, carry it; 0 outside a call), the batch's first read `lo` (-1 when
the span is not one batch's), and its process.  The spans:

  host.call          map_batch / map_batch_pe: one call
  host.prepare       prepare_batch of one batch (both mates for PE)
  host.dispatch      one batch's device call: H2D copy plus graph replay or
                     eager enqueue
  host.d2h           models/host.to_host: one device-to-host copy, which
                     waits on the card
  host.gdrop         the dense re-run of a batch with gdrop, its copy in
  host.submit        handing one batch's finalize task to the pool
  host.finalize      one batch's finalize in this process (no pool)
  host.finalize_wait blocked on one pool task's result, in input order
  host.unpack        one pool task's SAM text read back from its file and
                     split into its records
  pool.task          one task's finalize, formatting and packing in its
                     worker process: timed there, handed back with the
                     task's records when the task was submitted with the
                     recorder on
  io.read_wait       io/fastq.Prefetcher: blocked on the decode-ahead queue
  io.write           cli.cmd_search: one group's records through SamWriter
                     / BamWriter

The counters (plain integers):

  graph.capture[<key>], graph.replay[<key>]  CUDA graphs captured and
      replayed per key (models/graphs.key_label)
  graph.launches[<kernel>]  each replay's captured launches, so that launch
      counts see replays (ops/kernels.LAUNCHES counts Python-side launches)
  eager.tail, eager.ineligible, eager.dense  one card's device calls that
      did not replay, by reason (models/graphs.eager_reason)
  gdrop.batches, gdrop.reads  batches re-run dense, and their flagged reads
  pool.text_records, pool.text_bytes  records that came back from the pool
      as SAM text, and the text's length (one byte a character of SAM)
  sam.ga_gapped_records  records of a G->A search (XR:Z:GA) whose CIGAR has
      an I or a D, counted by the pool worker beside its pool.task span (or
      in models/host for a finalize in this process)
  pe.pairs, pe.rescue_hits  pairs finished by models/host.map_batch_pe, and
      of them those whose mate came from the rescue scan (no proper pair
      from the join, a rescue hit: the D2H outputs pair_valid, resc_valid)
  pe.proper_records, pe.mate_unmapped_records  PE records with FLAG 0x2,
      and with FLAG 0x8, read from each task's FLAG column (io/sam.SamText)

One clock: perf_counter_ns is CLOCK_MONOTONIC on Linux, shared by every
process of the host, so the pool workers' spans compare with the main
process's as they are.

`device_trace(dir, device)` is the `--profile` run: a torch.profiler trace
(host activity, and the card's kernels when mapping on a CUDA device, CUDA
graph replays included) written as a Chrome trace to trace_path(dir), with
the recorder on; each span of this process is also a record_function range
`btbs.<span>` on the trace's own timeline, and after the export the pool
workers' `pool.task` spans are appended to the file as one track per worker
pid, put on the trace's clock by an anchor range (`btbs.anchor`) opened at
the start beside its perf_counter_ns.  `report(snapshot)` is the stage
line the CLI prints with it.

This module imports no torch at its top: the pool's spawned workers import
it (through models/pool.py) without torch.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

ANCHOR = "btbs.anchor"

_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start: int          # perf_counter_ns
    end: int
    sid: int
    parent: int         # sid of the enclosing span in the thread, or 0
    call: int           # id of the map_batch / map_batch_pe call, or 0
    lo: int             # the batch's first read, or -1
    pid: int


class _Open:
    """An enabled span while it is open."""

    __slots__ = ("rec", "name", "lo", "call", "sid", "parent", "rf", "t0")

    def __init__(self, rec: "Recorder", name: str, lo: int, new_call: bool):
        self.rec, self.name, self.lo = rec, name, lo
        self.call = next(rec._calls) if new_call else None

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        up = stack[-1] if stack else None
        self.parent = up.sid if up is not None else 0
        if self.call is None:
            self.call = up.call if up is not None else 0
        self.sid = next(rec._ids)
        stack.append(self)
        self.rf = None
        if rec._annotate is not None:
            self.rf = rec._annotate("btbs." + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        rec._stack().pop()
        rec.add(Span(self.name, self.t0, t1, self.sid, self.parent,
                     self.call, self.lo, rec.pid))
        return False


class Recorder:
    """Spans and counters of one process while `on` (module docstring)."""

    def __init__(self):
        self.on = False
        self.pid = os.getpid()
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._annotate = None       # record_function, under device_trace
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._calls = itertools.count(1)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, lo: int = -1, call: bool = False):
        """A context manager timing the block as span `name` (`lo`: the
        batch's first read; `call`: the block is a new call).  Off: the
        shared null context."""
        if not self.on:
            return _NULL
        return _Open(self, name, lo, call)

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            self.counters[name] = self.counters.get(name, 0) + n

    def add(self, span: Span | None) -> None:
        """Keeps a finished span (a worker's, handed back with its task's
        records) while on."""
        if self.on and span is not None:
            self.spans.append(span)

    def task_trace(self, lo: int):
        """What a pool task carries so that its worker times it: (call id,
        lo) while on, else None."""
        if not self.on:
            return None
        stack = self._stack()
        return (stack[-1].call if stack else 0, lo)

    def start(self, annotate=None) -> None:
        """Empties the recorder and switches it on; `annotate` (the
        profiler's record_function) also opens each span of this process
        as a range of that name prefixed `btbs.`."""
        self.spans = []
        self.counters = {}
        self.pid = os.getpid()
        self._annotate = annotate
        self.on = True

    def stop(self) -> dict:
        """Switches the recorder off; its snapshot."""
        self.on = False
        self._annotate = None
        return self.snapshot()

    def snapshot(self) -> dict:
        """{"spans": [Span, ...] in the order they ended, "counters":
        {name: n}, "pid": this process}."""
        return {"spans": list(self.spans), "counters": dict(self.counters),
                "pid": self.pid}


REC = Recorder()
span = REC.span
count = REC.count


def task_span(trace, t0: int) -> Span | None:
    """In a pool worker: the `pool.task` span of a task that carried
    `trace` (Recorder.task_trace) and began at perf_counter_ns t0, or None
    for a task submitted with the recorder off."""
    if trace is None:
        return None
    call, lo = trace
    return Span("pool.task", t0, time.perf_counter_ns(), 0, 0, call, lo,
                os.getpid())


def totals(snap: dict) -> dict[str, list]:
    """{span name: [seconds, count]} over the snapshot's spans."""
    out: dict[str, list] = {}
    for s in snap["spans"]:
        t = out.setdefault(s.name, [0.0, 0])
        t[0] += (s.end - s.start) / 1e9
        t[1] += 1
    return out


def report(snap: dict, first: dict | None = None) -> str:
    """Each span's total and count, `name=12.3ms/4x`, two spaces apart: the
    spans `first` names first, under its labels ({span: label}), then the
    rest by name; then the counters, `name=n`, by name."""
    first = first or {}
    tot = totals(snap)
    names = [n for n in first if n in tot] + sorted(set(tot) - set(first))
    parts = [f"{first.get(n, n)}={tot[n][0] * 1e3:.1f}ms/{tot[n][1]}x"
             for n in names]
    parts += [f"{k}={v}" for k, v in sorted(snap["counters"].items())]
    return "  ".join(parts)


def trace_path(trace_dir: str) -> str:
    """The file device_trace writes into trace_dir."""
    return os.path.join(trace_dir, f"trace_{os.getpid()}.json")


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device=None):
    """torch.profiler trace of everything inside the block, with the
    recorder on, written as a Chrome trace to trace_path(trace_dir) on exit
    with the pool workers' tracks (no-op if trace_dir is None).  CUDA
    activity is recorded when `device` is a CUDA device."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        with record_function(ANCHOR):
            anchor_ns = time.perf_counter_ns()
        REC.start(annotate=record_function)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(device)
            snap = REC.stop()
    path = trace_path(trace_dir)
    prof.export_chrome_trace(path)
    add_worker_tracks(path, snap["spans"], anchor_ns)


def add_worker_tracks(path: str, spans, anchor_ns: int) -> int:
    """Appends the `pool.task` spans to the Chrome trace at `path`, one
    track (process) per worker pid, on the trace's clock: the trace's
    `btbs.anchor` range began at perf_counter_ns anchor_ns.  Returns the
    number of spans appended."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    anchor = [e for e in events if e.get("name") == ANCHOR
              and e.get("ph") == "X"
              and e.get("cat", "").startswith("user_annotation")]
    tasks = [s for s in spans if s.name == "pool.task"]
    if not anchor or not tasks:
        return 0
    offset_us = float(anchor[0]["ts"]) - anchor_ns / 1e3
    for pid in sorted({s.pid for s in tasks}):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": f"btbs pool worker {pid}"}})
    for s in tasks:
        events.append({"ph": "X", "cat": "btbs_pool", "name": s.name,
                       "pid": s.pid, "tid": 0,
                       "ts": s.start / 1e3 + offset_us,
                       "dur": (s.end - s.start) / 1e3,
                       "args": {"call": s.call, "lo": s.lo}})
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(tasks)
