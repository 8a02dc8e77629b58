"""The port's own spans in a run of a cell: the harness's run, as
`python3 -m wgbs_bench` makes it, with the port's recorder
(bitmapperbs_tpu_torch/utils/profiling.py) switched on beside it.

    python3 -m wgbs_bench.port_trace --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--port <0|1>]

`run.run` runs unchanged.  With `--port 1` (the default) the recorder is
switched on where the harness resets its spans after the warm-up and off
when the window closes, so the window's calls, pool tasks and waits are
recorded inside the program; `--port 0` leaves it off, for the recorder's
cost in interleaved runs.  The command prints the harness's INFO and
result lines, then a `PORT` line (JSON) with what `readings` reads from
the port's spans (`port_record` puts them into a record shaped as the
harness's `t`, under `port`):

  host.finalize_wait_share (%)  host.finalize_wait over `spans_s`
  host.main_ms_per_kread        host.prepare + host.dispatch + host.submit
                                + host.finalize per 1,000 reads mapped
                                outside the profiled stretch: the main
                                thread's own work in a call
  pool.busy_share (%)           pool.task over workers x `spans_s`
  pool.return_lag_ms            median, over tasks whose host.finalize_wait
                                began before their pool.task ended, of wait
                                end - task end (None under 10 such tasks)
  device.idle_in_finalize_wait_share (%)  the card's idle time in the
                                traced sub-window while the main thread was
                                in host.finalize_wait, over all its idle time

As in the harness, the spans that end while its spans are paused (the
profiled stretch) are left out of these, except the last, which reads the
profiled stretch alone.  In a traced run on a card, `align` puts the port's
spans on the profile's clock (the `wgbs.subwindow` range opens at the
perf_counter `t0` the window keeps) and splits the sub-window's idle time
by the innermost main-thread port span and the number of workers in a
pool.task (`idle_by_port_span`), with a causal check of the alignment:
each device operation is joined to the runtime call that launched it (its
correlation id), and no operation launched inside a batch's host.dispatch
may start before that span's aligned start (`min_slack_us`).  `inside`
holds the port's span totals beside the harness's own: host.d2h against
`to_host`, host.call against `map`, io.read_wait against `input`.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
from collections import defaultdict

from wgbs_bench import cells, run
from wgbs_bench.trace import Spans, _union

MAIN_WORK = ("host.prepare", "host.dispatch", "host.submit", "host.finalize")
OUTSIDE = "outside port spans"
MIN_LAG_TASKS = 10
# the harness's spans around port spans: {port span: harness span}, which
# the profile holds as `wgbs.<span>` ranges
HARNESS = {"host.d2h": "to_host", "host.call": "map", "io.read_wait": "input"}


def port_record(snap: dict, sub: dict, window_s: float, reads: int,
                workers: int) -> dict:
    """The harness-shaped record of one run: `spans_s`, `cpu_reads` and
    `port` (the recorder's spans and counters, `p0`, `paused_s`, `t0`, the
    pool's `workers`); sub is the harness's window() record."""
    return {"spans_s": window_s - sub.get("paused_s", 0.0),
            "cpu_reads": reads - sub.get("paused_reads", 0),
            "port": {"spans": snap["spans"], "counters": snap["counters"],
                     "pid": snap["pid"], "p0": sub.get("p0"),
                     "paused_s": sub.get("paused_s", 0.0),
                     "t0": sub.get("t0"), "workers": workers}}


def outside_spans(port: dict) -> list:
    """The port's spans that did not end inside the profiled stretch."""
    p0 = port["p0"]
    if p0 is None:
        return list(port["spans"])
    a, b = p0 * 1e9, (p0 + port["paused_s"]) * 1e9
    return [s for s in port["spans"] if not a <= s.end <= b]


def _seconds(spans, *names) -> float:
    return sum(s.end - s.start for s in spans if s.name in names) / 1e9


def finalize_wait_share(t):
    p = t.get("port")
    if not p or t["spans_s"] <= 0:
        return None
    sp = outside_spans(p)
    if not any(s.name == "host.call" for s in sp):
        return None
    return 100.0 * _seconds(sp, "host.finalize_wait") / t["spans_s"]


def main_ms_per_kread(t):
    p = t.get("port")
    if not p or not t.get("cpu_reads"):
        return None
    sp = outside_spans(p)
    if not any(s.name == "host.call" for s in sp):
        return None
    return _seconds(sp, *MAIN_WORK) * 1e3 / (t["cpu_reads"] / 1e3)


def pool_busy_share(t):
    p = t.get("port")
    if not p or not p["workers"] or t["spans_s"] <= 0:
        return None
    sp = outside_spans(p)
    if not any(s.name == "pool.task" for s in sp):
        return None
    return 100.0 * _seconds(sp, "pool.task") / (p["workers"] * t["spans_s"])


def pool_return_lag_ms(t):
    p = t.get("port")
    if not p:
        return None
    sp = outside_spans(p)
    waits = {(s.call, s.lo): s for s in sp if s.name == "host.finalize_wait"}
    lags = []
    for s in sp:
        w = waits.get((s.call, s.lo)) if s.name == "pool.task" else None
        if w is not None and w.start < s.end:
            lags.append((w.end - s.end) / 1e6)
    return statistics.median(lags) if len(lags) >= MIN_LAG_TASKS else None


def idle_in_finalize_wait_share(t):
    a = (t.get("port") or {}).get("aligned")
    if not a or a["idle_s"] <= 0:
        return None
    return 100.0 * sum(a["idle_by_port_span"].get(
        "host.finalize_wait", {}).values()) / a["idle_s"]


READERS = {"host.finalize_wait_share": finalize_wait_share,
           "host.main_ms_per_kread": main_ms_per_kread,
           "pool.busy_share": pool_busy_share,
           "pool.return_lag_ms": pool_return_lag_ms,
           "device.idle_in_finalize_wait_share": idle_in_finalize_wait_share}


def readings(t) -> dict:
    return {k: f(t) for k, f in READERS.items()}


def align(events, port: dict) -> dict:
    """The port's spans on the clock of a torch.profiler run (events:
    FunctionEvent-like, `name`, `device_type`, `time_range.start/end` in
    us, `id` the correlation id) that holds one `wgbs.subwindow` range,
    opened at perf_counter port["t0"].  Returns {} without that range.

    The window takes t0 just before it opens that range, so the anchor's
    offset (`anchor_offset_us`) is an upper bound of the true one.  The
    harness's own ranges in the profile contain the port's spans that run
    inside them (HARNESS), which bounds the offset from both sides
    (`offset_bounds_us`); `offset_us`, the one used, is the least upper
    bound, so a check against it errs towards a negative slack.

    `offset_us` (profile us = perf_counter us + offset); `idle_s`, the
    sub-window's time with no device operation; `idle_by_port_span`
    {innermost main-thread span or OUTSIDE: {workers in a pool.task:
    seconds}}; the causal check: `launched_in_dispatch` operations whose
    launch lies in a host.dispatch span, `min_slack_us` the least of their
    start less that span's aligned start (negative: an operation began
    before its batch was dispatched), and `launches_outside_port_spans`,
    launches of the sub-window inside no main-thread port span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    sub = [e for e in events if e.name == "wgbs.subwindow"
           and e.device_type != cuda]
    if not sub or port.get("t0") is None:
        return {}
    w0, w1 = sub[0].time_range.start, sub[0].time_range.end
    anchor = w0 - port["t0"] * 1e6
    bounds = offset_bounds(events, port, anchor, w0, w1)
    off = anchor if bounds is None else min(anchor, bounds[1])

    def us(ns):
        return ns / 1e3 + off

    ops = [e for e in events if e.device_type == cuda
           and not e.name.startswith(("wgbs.", "btbs."))]
    busy = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in ops if e.time_range.end > w0
                   and e.time_range.start < w1
                   and e.time_range.end > e.time_range.start])
    main = [(us(s.start), us(s.end), s) for s in port["spans"]
            if s.pid == port["pid"] and us(s.end) > w0 and us(s.start) < w1]
    tasks = [(us(s.start), us(s.end)) for s in port["spans"]
             if s.name == "pool.task" and us(s.end) > w0
             and us(s.start) < w1]

    # sweep: +1 / -1 of the card's busy intervals, main spans, tasks
    marks = [(w0, 0, None), (w1, 0, None)]
    for a, b in busy:
        marks += [(a, 1, "busy"), (b, -1, "busy")]
    for a, b, s in main:
        marks += [(max(a, w0), 1, s), (min(b, w1), -1, s)]
    for a, b in tasks:
        marks += [(max(a, w0), 1, "task"), (min(b, w1), -1, "task")]
    marks.sort(key=lambda m: (m[0], m[1]))
    by: dict = defaultdict(lambda: defaultdict(float))
    n_busy = n_tasks = 0
    open_spans: dict = {}
    prev, idle = w0, 0.0
    for t, step, what in marks:
        if t > prev and n_busy == 0 and w0 <= prev and t <= w1:
            inner = max(open_spans.values(), key=lambda s: s.start,
                        default=None)
            name = inner.name if inner is not None else OUTSIDE
            by[name][n_tasks] += (t - prev) / 1e6
            idle += (t - prev) / 1e6
        prev = max(prev, t)
        if what == "busy":
            n_busy += step
        elif what == "task":
            n_tasks += step
        elif what is not None:
            if step > 0:
                open_spans[what.sid] = what
            else:
                open_spans.pop(what.sid, None)

    # causality: each operation against the runtime call that launched it
    op_ids = {e.id for e in ops}
    launch = {e.id: e.time_range.start for e in events
              if e.device_type != cuda and e.name.startswith("cu")
              and e.id in op_ids}
    disp = sorted((a, b) for a, b, s in main if s.name == "host.dispatch")
    starts = [a for a, _ in disp]
    slack, outside = [], 0
    for t in launch.values():
        if w0 <= t <= w1 and not any(a <= t <= b for a, b, _ in main):
            outside += 1
    for e in ops:
        t = launch.get(e.id)
        if t is None or not w0 <= e.time_range.start <= w1:
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= disp[k][1]:
            slack.append(e.time_range.start - disp[k][0])
    return {"anchor_offset_us": anchor, "offset_bounds_us": bounds,
            "offset_us": off, "window_s": (w1 - w0) / 1e6, "idle_s": idle,
            "idle_by_port_span": {k: dict(v) for k, v in by.items()},
            "launched_in_dispatch": len(slack),
            "min_slack_us": min(slack) if slack else None,
            "launches_outside_port_spans": outside}


def offset_bounds(events, port: dict, anchor: float, w0: float, w1: float):
    """[least, greatest] offset (us) at which every main-thread port span
    named in HARNESS that starts in [w0, w1) sits inside the harness range
    that holds it (found with the anchor's offset), or None where none
    pairs or the bounds cross."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ranges = {}
    for name in HARNESS.values():
        rs = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == "wgbs." + name and e.device_type != cuda)
        ranges[name] = ([a for a, _ in rs], rs)
    lo, hi, n = float("-inf"), float("inf"), 0
    for s in port["spans"]:
        name = HARNESS.get(s.name)
        a, b = s.start / 1e3, s.end / 1e3
        if name is None or s.pid != port["pid"] \
                or not w0 <= a + anchor < w1:
            continue
        starts, rs = ranges[name]
        k = bisect.bisect_right(starts, a + anchor) - 1
        if k < 0:
            continue
        lo, hi = max(lo, rs[k][0] - a), min(hi, rs[k][1] - b)
        n += 1
    return [lo, hi] if n and lo <= hi else None


def inside_outside(port: dict, harness: dict) -> dict:
    """The port's totals beside the harness's spans, both outside the
    profiled stretch: {port span: [port s, harness span, harness s]}."""
    sp = outside_spans(port)
    return {name: [_seconds(sp, name), h, harness.get(h)]
            for name, h in HARNESS.items()}


def measure(opts, device, port: bool = True, root: str = cells.ROOT):
    """run.run(opts, device) with the port's recorder on in its window
    (`port`); (result, info, port line)."""
    from bitmapperbs_tpu_torch.utils.profiling import REC

    state: dict = {}

    class PortSpans(Spans):
        def __init__(self, on):
            super().__init__(on)
            state["spans"] = self

        def reset(self):
            super().reset()
            if port:
                REC.start()

    def window(loop, seconds, spans, traced=None, cpu=lambda: 0.0):
        t_open, t_close, sub = real_window(loop, seconds, spans, traced, cpu)
        snap = REC.stop() if port else {"spans": [], "counters": {},
                                        "pid": os.getpid()}
        state.update(snap=snap, sub=dict(sub), prof=sub.get("prof"),
                     window_s=t_close - t_open, reads=loop.counts.reads)
        return t_open, t_close, sub

    real_spans, real_window = run.Spans, run.window
    run.Spans, run.window = PortSpans, window
    try:
        result, info = run.run(opts, device, root=root)
    finally:
        run.Spans, run.window = real_spans, real_window
    conf = cells.cell(opts.workload, root)["config"]
    threads = run.program_config(conf)[1].threads
    t = port_record(state["snap"], state["sub"], state["window_s"],
                    state["reads"], threads if threads > 1 else 0)
    if state["prof"] is not None:
        t["port"]["aligned"] = align(state["prof"].events(), t["port"])
    line = {"port": port, "readings": readings(t),
            "counters": t["port"]["counters"],
            "spans": {k: [_seconds(outside_spans(t["port"]), k),
                          sum(s.name == k for s in t["port"]["spans"])]
                      for k in sorted({s.name for s in t["port"]["spans"]})},
            "inside": inside_outside(t["port"],
                                     dict(state["spans"].totals)),
            "spans_s": t["spans_s"], "cpu_reads": t["cpu_reads"],
            "aligned": t["port"].get("aligned")}
    return result, info, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m wgbs_bench.port_trace")
    ap.add_argument("--port", type=int, choices=(0, 1), default=1)
    mine, rest = ap.parse_known_args(argv)
    opts = run.parse(rest)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("error: no CUDA device\n")
        return 2
    result, info, line = measure(opts, torch.device("cuda:0"),
                                 bool(mine.port))
    print("INFO " + json.dumps(info, default=str), flush=True)
    print(json.dumps(result), flush=True)
    print("PORT " + json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
