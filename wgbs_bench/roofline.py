"""The kernels' rooflines: the least time the card could take on a launch's
work, against the time the launch takes alone.

Frozen copies of chip_smoke.py's counts (the bytes a launch must move, for
its own arguments) and of its graph timing.  The count depends only on the
launch's inputs, so it stays right whatever implements the kernel.  Peaks
are NVIDIA's data sheet for the H100 SXM at its 700 W limit; the card's
power limit is printed beside every share.
"""
from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
CP_ROW_BYTES = 68                  # one checkpoint row: 17 uint32
# bytes per locate lane beside its rows: the int64 block and position in,
# the int64 result out, the valid byte and the 4-byte SA sample
LOCATE_LANE_BYTES = 2 * 8 + 1 + 4 + 8


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def fm_locate_bytes(lanes: int, rows: int, n_lanes: int | None) -> float:
    """Rows fetched x 68 B, the live lanes' bytes, 8 B for each lane past
    the fill (it writes its 0 and loads nothing)."""
    live = lanes if n_lanes is None else min(n_lanes, lanes)
    return rows * CP_ROW_BYTES + live * LOCATE_LANE_BYTES + (lanes - live) * 8


def flat_expand_bytes(sp, starts, CAP: int) -> int:
    """The seed intervals and starts read once (a broadcast start once), the
    lengths, and every slot's five int64 fields and valid byte written."""
    B, F, S = sp.shape
    starts_n = B * S * (F if starts.stride(1) else 1)
    return (2 * sp.numel() + starts_n + B) * 8 + CAP * (5 * 8 + 1) + 8 \
        + B * F + B


def pair_join_bytes(B: int, F1: int, F2: int, Kc: int) -> int:
    """Every slot's score (int32) and anchor (int64) of both mates read
    once, the two lengths read once, the nine outputs written once."""
    return B * (F1 + F2) * Kc * 12 + B * 2 * 8 + B * (3 * 4 + 6 * 8)


def graph_ms(fn, calls: int = 20, replays: int = 7) -> float:
    """Device ms per call of fn() from CUDA events around a CUDA graph of
    `calls` calls, the median of `replays` replays: the launches back to
    back, with no host between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


WATCHED = ("fm_locate", "flat_expand", "pair_join")


def capture(kernels, run) -> dict:
    """The arguments that run() hands each watched kernel wrapper of the
    port's ops.kernels module, as they arrive (strides kept: a broadcast
    start stays one): {name: [(args, kw)]}; the wrappers are restored
    after."""
    import torch

    saved = {name: getattr(kernels, name) for name in WATCHED}
    seen: dict = {name: [] for name in WATCHED}

    def recording(name):
        def call(*args, **kw):
            seen[name].append((args, kw))
            return saved[name](*args, **kw)
        return call

    try:
        for name in WATCHED:
            setattr(kernels, name, recording(name))
        run()
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)
    return seen


def measure(kernels, seen: dict) -> dict:
    """{name: {"bound_ms", "ms", "launches"}} summed over each kernel's
    captured launches, each timed alone."""
    import torch

    out = {}
    for name, calls in seen.items():
        if not calls:
            continue
        kern = getattr(kernels, name)
        total_bound = total_ms = 0.0
        for args, kw in calls:
            if name == "fm_locate":
                shape = torch.broadcast_shapes(*(a.shape for a in args[1:4]))
                rows = torch.zeros(shape, dtype=torch.int32,
                                   device=args[2].device)
                kern(*args, **kw, rows_out=rows)
                n = kw.get("n_lanes")
                nbytes = fm_locate_bytes(rows.numel(), int(rows.sum()),
                                         None if n is None else int(n))
            elif name == "flat_expand":
                nbytes = flat_expand_bytes(args[0], args[2], args[7])
            else:
                B, F1, Kc = args[0].shape
                nbytes = pair_join_bytes(B, F1, args[2].shape[1], Kc)
            total_bound += bound_ms(nbytes)
            total_ms += graph_ms(lambda: kern(*args, **kw))
        out[name] = {"bound_ms": total_bound, "ms": total_ms,
                     "launches": len(calls)}
    return out
