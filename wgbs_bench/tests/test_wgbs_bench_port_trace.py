"""wgbs_bench/port_trace.py: its readings of the port's spans on synthetic
records (their None cases included), the alignment of the port's spans
with a profile of known offset and gaps, and runs of the tiny SE cell on
the CPU with the recorder on and off; the harness's own run never switches
the recorder on."""
import argparse
import types

import pytest

from bitmapperbs_tpu_torch.utils import profiling
from bitmapperbs_tpu_torch.utils.profiling import REC, Span
from wgbs_bench import port_trace as pt
from wgbs_bench.tests.helpers import make_root, tiny_run

MAIN, WORKER = 1, 2
T0 = 10.0                       # perf_counter s at the sub-window's open


def sp(name, a_ms, b_ms, call=1, lo=-1, pid=MAIN, sid=0):
    """A span from a_ms to b_ms after T0."""
    return Span(name, int((T0 + a_ms / 1e3) * 1e9),
                int((T0 + b_ms / 1e3) * 1e9), sid, 0, call, lo, pid)


def record(spans, spans_s=2.0, reads=4000, workers=2, p0=None, paused_s=0.0):
    return {"spans_s": spans_s, "cpu_reads": reads,
            "port": {"spans": spans, "counters": {}, "pid": MAIN, "p0": p0,
                     "paused_s": paused_s, "t0": T0, "workers": workers}}


def test_readings_of_the_spans():
    spans = [sp("host.call", 0, 1000, sid=1), sp("host.prepare", 0, 100),
             sp("host.dispatch", 100, 150), sp("host.submit", 150, 160),
             sp("host.d2h", 160, 200), sp("host.finalize_wait", 300, 700)]
    for k in range(12):          # 12 tasks; their waits end 5 ms later
        spans += [sp("pool.task", 100 + k, 200 + k, lo=k, pid=WORKER),
                  sp("host.finalize_wait", 150 + k, 205 + k, lo=k)]
    t = record(spans)
    assert pt.finalize_wait_share(t) == pytest.approx(
        100 * (0.4 + 12 * 0.055) / 2.0)
    assert pt.main_ms_per_kread(t) == pytest.approx(160 / 4)
    assert pt.pool_busy_share(t) == pytest.approx(100 * 1.2 / (2 * 2.0))
    assert pt.pool_return_lag_ms(t) == pytest.approx(5.0)
    assert pt.idle_in_finalize_wait_share(t) is None        # no profile


def test_readings_none_where_nothing_is_read():
    assert all(v is None for v in pt.readings({"spans_s": 1.0,
                                               "cpu_reads": 10}).values())
    empty = record([])
    assert all(v is None for v in pt.readings(empty).values())
    no_pool = record([sp("host.call", 0, 10), sp("host.finalize", 1, 9)],
                     workers=0)
    assert pt.pool_busy_share(no_pool) is None
    assert pt.main_ms_per_kread(no_pool) == pytest.approx(8 / 4)
    few = record([sp("host.call", 0, 100)]
                 + [sp("pool.task", 1, 5, lo=k, pid=WORKER)
                    for k in range(9)]
                 + [sp("host.finalize_wait", 2, 6, lo=k) for k in range(9)])
    assert pt.pool_return_lag_ms(few) is None               # 9 < 10 tasks
    late = record([sp("pool.task", 1, 5, lo=k, pid=WORKER) for k in range(12)]
                  + [sp("host.finalize_wait", 6, 7, lo=k) for k in range(12)])
    assert pt.pool_return_lag_ms(late) is None   # every wait began after


def test_profiled_stretch_left_out():
    """Spans that end while the harness's spans are paused do not count."""
    spans = [sp("host.call", 0, 100), sp("host.finalize_wait", 10, 90),
             sp("host.call", 500, 600), sp("host.finalize_wait", 510, 590)]
    t = record(spans, spans_s=1.0, p0=T0 + 0.4, paused_s=0.3)
    assert pt.finalize_wait_share(t) == pytest.approx(100 * 0.08 / 1.0)
    assert [s.start for s in pt.outside_spans(t["port"])] == [
        spans[0].start, spans[1].start]


def ev(name, a_us, b_us, cuda=False, eid=0):
    import torch

    dt = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, device_type=dt.CUDA if cuda else dt.CPU, id=eid,
        time_range=types.SimpleNamespace(start=a_us, end=b_us))


def scene(t0_shift_s=0.0):
    """A profile whose sub-window opens at 1,000 us, 100 ms long; the port's
    spans on perf_counter with the sub-window opened at T0: one call, one
    dispatch (1-3 ms in), one worker task (20-80 ms), the ordered wait
    (50-90 ms); two device operations, one launched inside the dispatch."""
    events = [ev("wgbs.subwindow", 1000, 101000),
              ev("cudaGraphLaunch", 2100, 2200, eid=7),
              ev("kernel_a", 2500, 3500, cuda=True, eid=7),
              ev("cudaMemcpyAsync", 95000, 95100, eid=9),
              ev("Memcpy DtoH", 96000, 96500, cuda=True, eid=9),
              ev("cudaDeviceSynchronize", 100000, 100500, eid=11),
              ev("wgbs.subwindow", 1000, 101000, cuda=True)]
    port = record([sp("host.call", 0, 100, sid=1),
                   sp("host.dispatch", 1, 3, lo=0, sid=2),
                   sp("pool.task", 20, 80, lo=0, pid=WORKER),
                   sp("host.finalize_wait", 50, 90, lo=0, sid=3)])["port"]
    port["t0"] = T0 + t0_shift_s
    return events, port


def test_align_splits_the_idle_time_by_span_and_workers():
    events, port = scene()
    a = pt.align(events, port)
    assert a["offset_us"] == a["anchor_offset_us"] == pytest.approx(
        1000 - T0 * 1e6)
    assert a["offset_bounds_us"] is None        # no harness range
    assert a["window_s"] == pytest.approx(0.1)
    want = {"host.call": {0: 0.001 + 0.017 + 0.0095, 1: 0.030},
            "host.dispatch": {0: 0.0005 + 0.0005},
            "host.finalize_wait": {1: 0.030, 0: 0.010}}
    got = a["idle_by_port_span"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert set(got[k]) == set(v)
        for n, s in v.items():
            assert got[k][n] == pytest.approx(s, abs=1e-9), (k, n)
    assert a["idle_s"] == pytest.approx(0.1 - 0.0015)
    assert (a["launched_in_dispatch"], a["launches_outside_port_spans"]) \
        == (1, 0)
    assert a["min_slack_us"] == pytest.approx(500.0)
    t = {"port": dict(port, aligned=a)}
    assert pt.idle_in_finalize_wait_share(t) == pytest.approx(
        100 * 0.040 / 0.0985)


def test_align_shows_a_wrong_offset():
    """The sub-window's open taken 1.5 ms too early puts the dispatch after
    the runtime call inside it: the launch no longer lies in the batch's
    dispatch span."""
    events, port = scene(t0_shift_s=-0.0015)
    a = pt.align(events, port)
    assert a["launched_in_dispatch"] == 0 and a["min_slack_us"] is None
    assert pt.align(events[1:], port) == {}           # no sub-window range


def test_harness_ranges_bound_a_late_anchor():
    """The range opened 0.5 ms after t0 was read: the harness's `map`
    range around host.call (opened 1 us before it, closed 1 us after)
    bounds the offset to within 2 us of the truth, the least upper bound is
    used, and the launch lies in its dispatch again."""
    events, port = scene(t0_shift_s=-0.0005)
    events.append(ev("wgbs.map", 999, 101001))
    events.append(ev("wgbs.map", 999, 101001, cuda=True))
    a = pt.align(events, port)
    true = 1000 - T0 * 1e6
    assert a["anchor_offset_us"] == pytest.approx(true + 500)
    lo, hi = a["offset_bounds_us"]
    assert (lo, hi) == (pytest.approx(true - 1), pytest.approx(true + 1))
    assert a["offset_us"] == pytest.approx(true + 1)
    assert a["launched_in_dispatch"] == 1
    assert a["min_slack_us"] == pytest.approx(499.0)


def test_inside_outside_pairs_the_harness_spans():
    port = record([sp("host.d2h", 0, 10), sp("host.call", 0, 50),
                   sp("io.read_wait", 60, 61)])["port"]
    got = pt.inside_outside(port, {"to_host": 0.0105, "map": 0.06})
    assert got["host.d2h"] == [pytest.approx(0.01), "to_host", 0.0105]
    assert got["host.call"][1:] == ["map", 0.06]
    assert got["io.read_wait"][1:] == ["input", None]


@pytest.fixture
def tiny2(tmp_path, monkeypatch):
    """The tiny checkout with a finalize pool of two workers."""
    from wgbs_bench import cache

    monkeypatch.setattr(cache, "ROOT", str(tmp_path / "cache"))
    return make_root(str(tmp_path / "checkout"), threads=2)


def opts(trace):
    return argparse.Namespace(workload="tiny-se.bulk", seed=2**31 + 11,
                              seconds=2.0, trace=trace, control=False)


def test_the_harness_never_switches_the_recorder_on(tiny, monkeypatch):
    """`python3 -m wgbs_bench` itself leaves the port's recorder off, in
    untraced and traced runs: nothing is recorded, the results unchanged."""
    started = []
    monkeypatch.setattr(REC, "start", lambda *a, **k: started.append(1))
    for trace in (0, 1):
        before = len(REC.snapshot()["spans"])
        result, _ = tiny_run(tiny, "tiny-se.bulk", trace=trace)
        assert result["correct"] is True
        assert not REC.on and started == []
        assert len(REC.snapshot()["spans"]) == before


@pytest.mark.parametrize("port", [True, False])
def test_a_cpu_run_with_the_recorder(tiny2, port):
    """A traced run of the tiny SE cell with a pool of two: with the
    recorder on, the span readings come out and the port's host.call stays
    inside the harness's map; off, nothing is read.  No device trace on the
    CPU, so nothing is aligned."""
    import torch

    torch.set_num_threads(1)
    result, info, line = pt.measure(opts(1), torch.device("cpu"), port,
                                    root=tiny2)
    assert result["correct"] is True and not REC.on
    r = line["readings"]
    assert r["device.idle_in_finalize_wait_share"] is None
    assert line["aligned"] is None
    if not port:
        assert all(v is None for v in r.values()) and line["spans"] == {}
        return
    assert 0 < r["host.finalize_wait_share"] < 100
    assert r["host.main_ms_per_kread"] > 0
    assert 0 < r["pool.busy_share"] <= 100
    inside = line["inside"]
    assert 0 < inside["host.call"][0] <= inside["host.call"][2]
    assert 0 < inside["host.d2h"][0] <= inside["host.d2h"][2]
    assert line["spans"]["pool.task"][1] == line["spans"]["host.submit"][1]
    assert line["counters"]["eager.ineligible"] >= 1
    assert {"host.call", "host.prepare", "host.dispatch", "host.d2h",
            "host.submit", "host.finalize_wait", "pool.task",
            "io.read_wait"} <= set(line["spans"])
    assert profiling.REC.task_trace(0) is None
