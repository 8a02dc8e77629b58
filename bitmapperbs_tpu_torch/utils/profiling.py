"""Tracing / profiling utilities (counterpart of
bitmapperbs_tpu/utils/profiling.py).

  * `device_trace(dir, device)` -- context manager around torch.profiler
    (host activity, and the card's kernels when mapping on a CUDA device)
    that writes a Chrome trace (chrome://tracing, Perfetto) into DIR; wired
    to the CLI's `--profile DIR` flag;
  * `StageTimer` -- accumulating wall timers for coarse host-side stage
    attribution, synchronising the card at the end of a stage when given a
    tensor that lives on it; the CLI times its map and write stages with it
    and prints the report under `--profile`.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def trace_path(trace_dir: str) -> str:
    """The file device_trace writes into trace_dir."""
    return os.path.join(trace_dir, f"trace_{os.getpid()}.json")


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device=None):
    """torch.profiler trace of everything inside the block, written as a
    Chrome trace to trace_path(trace_dir) on exit (no-op if trace_dir is
    None).  CUDA activity is recorded when `device` is a CUDA device."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(trace_path(trace_dir))


class StageTimer:
    """Accumulating wall timers: `with timer("seed", sync=t): ...` (a tensor
    on a CUDA device synchronises that device before the clock stops)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if isinstance(sync, torch.Tensor) and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        self.totals[name] = self.totals.get(name, 0.0) + (
            time.perf_counter() - t0)
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "  ".join(
            f"{k}={self.totals[k] * 1e3:.1f}ms/{self.counts[k]}x"
            for k in sorted(self.totals))
