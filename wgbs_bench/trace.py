"""The traced run's spans and counters, recorded by the benchmark's own
wrappers around the calls into the port's layers (nothing in the port
changes), and the device trace of a sub-window of the measured window.

Spans (main thread, host clock): `input` (blocked on the reader's
Prefetcher), `map` (one map_batch / map_batch_pe call, its wall kept per
call), `to_host` (models.host.to_host: the one device-to-host copy of a
batch, which waits on the card), `write` (SamWriter.write of a call's
records).  While the profiler runs each span is also a
torch.profiler.record_function range named `wgbs.<span>`, so that an idle
gap of the card can be named by what the host was doing.  From the
profiler's start to its stop the spans are `paused`: the profiler slows the
host, so the span metrics leave that stretch out and divide by the rest of
the window (`spans_s`).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    """Accumulated span seconds and per-call walls; `on` False records
    nothing (the untraced run), nor does a span that ends while `paused`."""

    def __init__(self, on: bool):
        self.on = on
        self.totals: dict = defaultdict(float)
        self.call_walls: list = []
        self.profiling = False
        self.paused = False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        rf = None
        if self.profiling:
            import torch

            rf = torch.profiler.record_function("wgbs." + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            if self.paused:
                return
            self.totals[name] += dt
            if name == "map":
                self.call_walls.append(dt)

    def reset(self) -> None:
        self.totals.clear()
        self.call_walls.clear()

    @contextlib.contextmanager
    def wrapped(self, module, attr: str, name: str):
        """module.attr timed as span `name` while the block runs."""
        real = getattr(module, attr)

        def timed(*a, **kw):
            with self.span(name):
                return real(*a, **kw)

        setattr(module, attr, timed)
        try:
            yield
        finally:
            setattr(module, attr, real)


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_profile(prof) -> dict:
    """From a torch.profiler run that holds one `wgbs.subwindow` range:
    busy_s (the union of the card's operations inside it), window_s, the
    device operations that took most time, and the longest idle gaps, each
    named by the innermost harness span the main thread was in over most of
    it ("loop" between spans).
    The ranges of record_function appear twice, on the host and as
    annotations on the card's timeline: the host's are the spans, and the
    card's are no operation."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    host = [e for e in events if e.name.startswith("wgbs.")
            and e.device_type != cuda]
    sub = [e for e in host if e.name == "wgbs.subwindow"]
    if not sub:
        return {}
    w0, w1 = sub[0].time_range.start, sub[0].time_range.end
    ops = [e for e in events if e.device_type == cuda
           and not e.name.startswith("wgbs.")]
    dev = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
           for e in ops if e.time_range.end > w0 and e.time_range.start < w1]
    busy = _union([d for d in dev if d[1] > d[0]])
    busy_us = sum(b - a for a, b in busy)
    spans = [(e.time_range.start, e.time_range.end, e.name[5:])
             for e in host if e is not sub[0]]

    def host_in(t):
        inner = [s for s in spans if s[0] <= t < s[1]]
        return min(inner, key=lambda s: s[1] - s[0])[2] if inner else "loop"

    def host_over(g0, g1):
        """The innermost span the host was in over most of [g0, g1), read
        at 16 points across it."""
        names = [host_in(g0 + (k + 0.5) * (g1 - g0) / 16) for k in range(16)]
        return max(set(names), key=names.count)

    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((a - prev, prev))
        prev = max(prev, b)
    gaps.sort(reverse=True)
    by_name: dict = defaultdict(float)
    for e in ops:
        by_name[e.name[:160]] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[k, v / 1e6] for k, v in top],
            "idle_gaps": [[host_over(t, t + g), g / 1e6]
                          for g, t in gaps[:10]],
            "device_events": len(dev)}
