"""PyTorch port, the recorder of utils/profiling.py: off it records nothing
and opens no profiler range; on, the host loop's spans nest under their
call with its id, the pool workers' spans come back on the main process's
clock, records are the same with the recorder on and off, the counters
count, and a `--profile` trace holds the host spans and a track per
finalize worker."""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bitmapperbs_tpu.io.fastq import write_fastq  # noqa: E402
from bitmapperbs_tpu.index.build import parse_fasta  # noqa: E402
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,  # noqa: E402
                                            simulate_pairs, simulate_reads)
from bitmapperbs_tpu_torch.config import AlignerConfig  # noqa: E402
from bitmapperbs_tpu_torch.index.build import build_index  # noqa: E402
from bitmapperbs_tpu_torch.index.device import upload_index  # noqa: E402
from bitmapperbs_tpu_torch.models import host  # noqa: E402
from bitmapperbs_tpu_torch.models.pool import make_finalize_pool  # noqa: E402
from bitmapperbs_tpu_torch.utils import profiling  # noqa: E402
from bitmapperbs_tpu_torch.utils.profiling import REC  # noqa: E402

BS = 16


def cfg(**kw):
    base = dict(max_errors=4, indels=True, read_len_bucket=96,
                batch_size=BS, min_insert=100, max_insert=400)
    base.update(kw)
    return AlignerConfig(**base)


@pytest.fixture
def recording():
    """The recorder switched on for the test, and off after it."""
    REC.start()
    try:
        yield REC
    finally:
        REC.stop()


@pytest.fixture(scope="module")
def world():
    """A small index on the CPU, 40 reads (two full batches and a tail)
    and 20 pairs."""
    rng = np.random.default_rng(23)
    fa = random_genome_fasta(rng, contigs=(6000, 3000))
    idx = build_index(fa)
    genome = parse_fasta(fa)
    reads = [s.codes for s in simulate_reads(genome, 40, read_len=80, seed=4,
                                             sub_rate=0.01)]
    pairs = [(a.codes, b.codes) for a, b in simulate_pairs(
        genome, 20, read_len=80, seed=5, min_insert=150, max_insert=300)]
    return idx, upload_index(idx), reads, pairs


def run(world, pe: bool, pool=None, **kw):
    idx, dix, reads, pairs = world
    if pe:
        return host.map_batch_pe(idx, dix, cfg(paired=True, **kw), pairs,
                                 pool=pool)
    return host.map_batch(idx, dix, cfg(**kw), reads, pool=pool)


def lines(recs):
    return [r.line() for r in recs]


# ---- the recorder alone -----------------------------------------------------

def test_off_records_nothing_and_opens_no_range(world, monkeypatch):
    """Off (the default), a span is the one shared null context, nothing is
    recorded and no record_function range is entered."""
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: opened.append(name))
    REC.start()
    REC.stop()                                  # emptied, and off
    assert profiling.span("a") is profiling.span("b", 5, call=True)
    profiling.count("x")
    run(world, pe=False)
    run(world, pe=True)
    snap = REC.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {} and opened == []
    assert REC.task_trace(0) is None


def test_spans_nest_under_their_parents_per_thread(recording):
    """A span's parent is the innermost span open in its own thread; a
    call span starts a new call id, which the spans inside it carry."""
    import threading

    with profiling.span("outer", call=True):
        with profiling.span("inner", 3):
            t = threading.Thread(target=lambda: profiling.span("other")
                                 .__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    with profiling.span("second", call=True):
        pass
    profiling.count("c")
    profiling.count("c", 4)
    snap = REC.stop()
    by = {s.name: s for s in snap["spans"]}
    assert set(by) == {"outer", "inner", "other", "second"}
    assert by["outer"].parent == 0 and by["inner"].parent == by["outer"].sid
    assert by["other"].parent == 0 and by["other"].call == 0
    assert by["inner"].call == by["outer"].call != 0
    assert by["second"].call not in (0, by["outer"].call)
    assert by["inner"].lo == 3 and by["outer"].lo == -1
    assert by["outer"].start <= by["inner"].start <= by["inner"].end \
        <= by["outer"].end
    assert snap["counters"] == {"c": 5}
    profiling.count("c")                       # off again: not counted
    with profiling.span("late"):
        pass
    assert REC.snapshot()["counters"] == {"c": 5}
    assert [s.name for s in REC.snapshot()["spans"]] == [
        s.name for s in snap["spans"]]


def test_totals_and_report():
    """The stage line: the named spans first under their labels, the rest
    by name, then the counters (the report StageTimer printed)."""
    S = profiling.Span
    snap = {"spans": [S("seed", 0, 2_000_000, 1, 0, 0, -1, 1)] * 3
            + [S("verify", 0, 500_000, 2, 0, 0, -1, 1),
               S("host.call", 0, 7_000_000, 3, 0, 1, -1, 1),
               S("io.write", 0, 1_000_000, 4, 0, 0, -1, 1)],
            "counters": {"eager.tail": 2, "graph.replay[k]": 7}}
    tot = profiling.totals(snap)
    assert tot["seed"] == [pytest.approx(0.006), 3]
    assert tot["verify"] == [pytest.approx(0.0005), 1]
    assert profiling.report(snap, {"host.call": "map", "io.write": "write"}) \
        == ("map=7.0ms/1x  write=1.0ms/1x  seed=6.0ms/3x  verify=0.5ms/1x  "
            "eager.tail=2  graph.replay[k]=7")
    rep = profiling.report({"spans": snap["spans"][:4], "counters": {}})
    assert rep.startswith("seed=") and "ms/3x" in rep and "ms/1x" in rep
    assert rep.index("seed=") < rep.index("verify=")


def test_worker_tracks_on_the_trace_clock(tmp_path):
    """The pool.task spans go into the Chrome trace one process per worker,
    shifted by the anchor's offset; other spans are not added."""
    S = profiling.Span
    anchor_ns = 5_000_000_000
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": profiling.ANCHOR,
         "pid": 1, "tid": 1, "ts": 100.0, "dur": 1.0}]}))
    spans = [S("pool.task", anchor_ns + 2_000_000, anchor_ns + 5_000_000,
               0, 0, 3, 32, 77),
             S("pool.task", anchor_ns + 1_000, anchor_ns + 2_000, 0, 0, 3, 0,
               78),
             S("host.call", anchor_ns, anchor_ns + 9_000_000, 1, 0, 3, -1,
               1)]
    assert profiling.add_worker_tracks(str(path), spans, anchor_ns) == 2
    ev = json.loads(path.read_text())["traceEvents"]
    tasks = [e for e in ev if e["name"] == "pool.task"]
    assert [(e["pid"], e["ts"], e["dur"], e["args"]) for e in tasks] == [
        (77, 2100.0, 3000.0, {"call": 3, "lo": 32}),
        (78, 101.0, 1.0, {"call": 3, "lo": 0})]
    assert {e["pid"] for e in ev if e["ph"] == "M"} == {77, 78}


def test_device_trace_without_a_directory_is_a_no_op():
    with profiling.device_trace(None):
        assert not REC.on


# ---- the host loop ----------------------------------------------------------

@pytest.mark.parametrize("pe", [False, True])
def test_host_spans_nest_under_their_call(world, recording, pe):
    """In-process finalize: every batch span sits under its call's
    host.call and carries its id; the D2H copy of each batch and a forced
    gdrop re-run are there; records equal the recorder-off run's."""
    REC.stop()
    want = lines(run(world, pe, locate_flat_cap=1))
    REC.start()
    got = lines(run(world, pe, locate_flat_cap=1))
    run(world, pe)
    snap = REC.stop()
    assert got == want
    calls = [s for s in snap["spans"] if s.name == "host.call"]
    assert len(calls) == 2 and calls[0].call != calls[1].call
    by_sid = {s.sid: s for s in snap["spans"]}
    n = len(world[3] if pe else world[2])
    los = list(range(0, n, BS))
    for c in calls:
        mine = [s for s in snap["spans"] if s.call == c.call and s is not c]
        for name in ("host.prepare", "host.dispatch", "host.finalize"):
            got_los = [s.lo for s in mine if s.name == name]
            assert got_los == los, (name, got_los)
            assert all(by_sid[s.parent] is c for s in mine
                       if s.name == name)
        for s in mine:
            assert c.start <= s.start <= s.end <= c.end
    d2h = [s for s in snap["spans"] if s.name == "host.d2h"]
    gdrop = [s for s in snap["spans"] if s.name == "host.gdrop"]
    assert gdrop and all(s.call == calls[0].call for s in gdrop)
    assert len(d2h) == 2 * len(los) + len(gdrop)
    assert {by_sid[s.parent].name for s in d2h} == {"host.call",
                                                    "host.gdrop"}
    assert snap["counters"]["gdrop.batches"] == len(gdrop)
    assert snap["counters"]["gdrop.reads"] >= len(gdrop)
    # CPU tensors: every device call eager, the dense re-runs by reason
    assert snap["counters"]["eager.dense"] == len(gdrop)
    assert snap["counters"]["eager.ineligible"] == 2 * len(los)


def task_los(n: int, pe: bool, workers: int = 2) -> list[int]:
    """The first read (pair) of each pool task, as host.task_slices lays
    them out: one task a batch for SE; a PE batch's pairs split over the
    pool's workers."""
    return [lo + s for lo in range(0, n, BS)
            for s, _ in host.task_slices(min(BS, n - lo), workers,
                                         2 if pe else 1)]


@pytest.mark.parametrize("pe", [False, True])
def test_pool_task_spans_on_the_main_clock(world, pe):
    """A spawned pool of 2 made before the recorder was switched on: each
    task's pool.task span comes back with its records, from a worker's pid,
    inside its host.call and its submit-to-wait stretch; one
    host.finalize_wait per task; records equal with the recorder off."""
    import os

    idx = world[0]
    pool = make_finalize_pool(idx, cfg(paired=pe), 2)
    try:
        want = lines(run(world, pe, pool=pool))
        REC.start()
        try:
            got = lines(run(world, pe, pool=pool))
        finally:
            snap = REC.stop()
        again = lines(run(world, pe, pool=pool))
    finally:
        pool.terminate()
        pool.join()
    assert got == want == again
    (call,) = [s for s in snap["spans"] if s.name == "host.call"]
    tasks = [s for s in snap["spans"] if s.name == "pool.task"]
    waits = {s.lo: s for s in snap["spans"] if s.name == "host.finalize_wait"}
    submits = {s.lo: s for s in snap["spans"] if s.name == "host.submit"}
    n = len(world[3] if pe else world[2])
    assert sorted(s.lo for s in tasks) == sorted(waits) == sorted(submits) \
        == task_los(n, pe)
    if pe:      # two tasks a batch
        assert len(tasks) == 2 * len(range(0, n, BS))
    assert {s.pid for s in tasks} <= {p.pid for p in pool._pool} \
        and os.getpid() not in {s.pid for s in tasks}
    for t in tasks:
        assert t.call == call.call
        assert call.start <= submits[t.lo].start <= t.start <= t.end \
            <= waits[t.lo].end <= call.end
    assert not [s for s in snap["spans"] if s.name == "host.finalize"]


@pytest.mark.parametrize("pe", [False, True])
def test_pool_text_counters_and_unpack_spans(world, pe):
    """A pool of 2 with the recorder on: pool.text_records counts every
    record the tasks returned, pool.text_bytes their lines and newlines,
    and each task's text is split under one host.unpack span, after its
    host.finalize_wait; in-process, neither counts."""
    idx = world[0]
    pool = make_finalize_pool(idx, cfg(paired=pe), 2)
    try:
        REC.start()
        try:
            recs = run(world, pe, pool=pool)
        finally:
            snap = REC.stop()
    finally:
        pool.terminate()
        pool.join()
    n = len(world[3] if pe else world[2])
    c = snap["counters"]
    assert c["pool.text_records"] == len(recs) == n * (2 if pe else 1)
    assert c["pool.text_bytes"] == sum(len(r.line()) + 1 for r in recs) - (
        len(task_los(n, pe)))
    unpacks = {s.lo: s for s in snap["spans"] if s.name == "host.unpack"}
    waits = {s.lo: s for s in snap["spans"] if s.name == "host.finalize_wait"}
    assert sorted(unpacks) == sorted(waits) == task_los(n, pe)
    assert len([s for s in snap["spans"] if s.name == "host.unpack"]) \
        == len(unpacks)
    (call,) = [s for s in snap["spans"] if s.name == "host.call"]
    for lo, s in unpacks.items():
        assert s.parent == call.sid
        assert waits[lo].end <= s.start <= s.end <= call.end
    REC.start()
    try:
        run(world, pe)
    finally:
        snap = REC.stop()
    assert not {"pool.text_records", "pool.text_bytes"} & set(
        snap["counters"])
    assert not [s for s in snap["spans"] if s.name == "host.unpack"]


def test_task_trace_carries_the_open_call():
    REC.start()
    try:
        assert REC.task_trace(7) == (0, 7)
        with profiling.span("host.call", call=True) as c:
            assert REC.task_trace(32) == (c.call, 32)
    finally:
        REC.stop()
    t0 = time.perf_counter_ns()
    sp = profiling.task_span((4, 32), t0)
    assert (sp.name, sp.call, sp.lo) == ("pool.task", 4, 32)
    assert t0 <= sp.start <= sp.end
    assert profiling.task_span(None, t0) is None


# ---- --profile --------------------------------------------------------------

def test_profile_trace_holds_host_spans_and_worker_tracks(tmp_path, capsys):
    """`--profile` with a pool of 2: the Chrome trace holds btbs.host.*
    ranges and one track per finalize worker that ran a task, inside the
    trace's span of the run; the stage line names the eager calls."""
    import re

    from bitmapperbs_tpu_torch import cli

    fa = random_genome_fasta(np.random.default_rng(8), contigs=(4000,))
    (tmp_path / "ref.fa").write_text(fa)
    sims = simulate_reads(parse_fasta(fa), 48, read_len=80, seed=3)
    write_fastq(tmp_path / "r.fq", [s.codes for s in sims])
    assert cli.main(["index", str(tmp_path / "ref.fa")]) == 0
    prof = tmp_path / "prof"
    assert cli.main(["search", str(tmp_path / "ref.fa"), "--seq",
                     str(tmp_path / "r.fq"), "--platform", "cpu", "-t", "2",
                     "--batch-size", "16", "-o", str(tmp_path / "o.sam"),
                     "--profile", str(prof)]) == 0
    err = capsys.readouterr().err
    line = re.search(r"stages: (.*)", err)[1]
    assert line.startswith("map=") and "  write=" in line
    assert "host.finalize_wait=" in line and "eager.ineligible=" in line
    path = next(prof.glob("trace_*.json"))
    ev = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in ev}
    assert {"btbs.host.call", "btbs.host.prepare", "btbs.host.dispatch",
            "btbs.host.d2h", "btbs.host.submit", "btbs.host.finalize_wait",
            "btbs.io.write", "btbs.io.read_wait"} <= names
    tasks = [e for e in ev if e.get("name") == "pool.task"]
    workers = {e["pid"] for e in ev if e.get("ph") == "M"
               and e["args"].get("name", "").startswith("btbs pool worker")}
    assert len(tasks) == 3 and {e["pid"] for e in tasks} == workers
    calls = [e for e in ev if e.get("name") == "btbs.host.call"
             and e.get("ph") == "X"]
    lo = min(float(e["ts"]) for e in calls)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in calls)
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in tasks)
    assert not REC.on
