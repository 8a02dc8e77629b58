"""CUDA-graph replay of the single-card device calls: the port's
counterpart of the reference's jax.jit on models/aligner.map_batch_device
and models/paired.map_batch_pe_device (bitmapperbs_tpu/models/aligner.py,
bitmapperbs_tpu/models/paired.py), one captured program per static shape.

The first call of a key runs the device call once eagerly on a side stream
(the warm-up: the kernels are built and loaded, the small constant tensors
made, the shared-memory opt-ins set), then captures it on that stream into
a torch.cuda.CUDAGraph with its own private memory pool, on static input
buffers (reads, lengths).  Every call then copies its batch into the
static inputs, replays the graph on the current stream and clones the
graph's outputs on that stream into fresh tensors, so a batch still in
flight (models/host keeps up to MAX_INFLIGHT of them) keeps its results
when the next replay overwrites the static outputs.  Warm-up, capture and
replay run with the index's card current, whichever card the caller has
current.  A failed capture or replay raises: nothing here falls back to
the eager call.

The key is jit's cache key: (cfg, B, m_pad, min_read_len //
cfg.num_seeds), with mate 2's min_read_len // num_seeds after it for PE;
min_read_len reaches the device call only as that quotient (the seed
slices' lower bound, models/aligner._seed_stage).  The graphs of an index
are kept on it (DeviceIndex.graphs): a graph reads that index's tables, so
it goes, pool and all, when the index does; `clear(dix)` drops them
sooner.  Nothing bounds their number: a run holds one graph per config
group (error budget, length bucket) and per shortest-read quotient of its
full batches (chip_smoke.py counts them on trimmed reads; PERF.md has the
count).

Which calls replay a graph (`eligible`); every other call stays eager:
  * CUDA tensors only: on the CPU there is no graph;
  * full batches only (B == cfg.batch_size): the power-of-two tail batches
    of models/host._pad_rows stay eager, which bounds the graphs per run;
  * the compact pipeline only: the dense path (cfg.compact False: the gdrop
    re-run of models/host._gdrop_rerun, whose rows vary) is sized for the
    worst case, and a pool would keep its grids for the whole run;
  * a whole index on one card: the mesh and sharded mappers
    (parallel/shard.py) dispatch data slices eagerly, and never come here.
Any flat_chunks replays: the compact path keeps its flat buffer's fill
counts on the card (ops/kernels.flat_expand / flat_dedup), so the device
call reads nothing back to the host, whatever --sensitive or the Gbp PBAT
autotune set.
models/host.map_batch / map_batch_pe take `graphs=False` to stay eager
(the benchmark's roofline batch does); the CLI always passes True, under
--profile too: the profiler sees the kernels inside a replay.

The kernel wrappers count their launches in ops/kernels.LAUNCHES when they
run in Python: in the warm-up and while capturing, not at a replay.  Each
graph records what its capture launched (`DeviceGraph.launches`) and how
often it replayed; while utils/profiling's recorder is on, a capture and a
replay are also counted per key (`graph.capture[<key_label>]`,
`graph.replay[...]`) and each replay adds its captured launches to
`graph.launches[<kernel>]`.  `eager_reason` names why a call that does not
replay stays eager, which models/host counts.
"""
from __future__ import annotations

import time

import torch

from bitmapperbs_tpu_torch.config import AlignerConfig
from bitmapperbs_tpu_torch.index.device import DeviceIndex
from bitmapperbs_tpu_torch.models.aligner import map_batch_device
from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device
from bitmapperbs_tpu_torch.ops import kernels
from bitmapperbs_tpu_torch.utils.profiling import REC, count


def eligible(dix: DeviceIndex, cfg: AlignerConfig, rows: int) -> bool:
    """Whether a device call of `rows` batch rows on dix replays a graph
    (the rules of the module docstring)."""
    return (dix.device.type == "cuda" and not dix.sharded and cfg.compact
            and rows == cfg.batch_size)


def eager_reason(dix: DeviceIndex, cfg: AlignerConfig, rows: int,
                 graphs: bool = True) -> str:
    """The counter of a device call on dix that does not replay a graph:
    `eager.dense` (the gdrop re-run), `eager.tail` (a call that would
    replay but for its rows) or `eager.ineligible` (CPU tensors, a sharded
    index, graphs off)."""
    if not cfg.compact:
        return "eager.dense"
    if graphs and eligible(dix, cfg, cfg.batch_size):
        return "eager.tail"
    return "eager.ineligible"


def graph_key(cfg: AlignerConfig, rows: int, m_pad: int,
              *min_read_lens: int) -> tuple:
    """The cache key of a device call on one index: one min_read_len per
    mate."""
    return (cfg, rows, m_pad, *(mn // cfg.num_seeds for mn in min_read_lens))


def key_label(key: tuple) -> str:
    """A graph key as the counters name it: `e<max_errors>/<rows>x<m_pad>/
    q<min_read_len // num_seeds>[,<mate 2's>]`."""
    cfg, rows, m_pad, *qs = key
    return (f"e{cfg.max_errors}/{rows}x{m_pad}/"
            f"q{','.join(str(q) for q in qs)}")


def _clone(out):
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    return out.clone()


class DeviceGraph:
    """One device call captured for a static shape on card `dev`: its
    static inputs, the graph and its outputs, what the capture launched
    (`launches`, counted by the wrappers while capturing), the warm-up's and
    the capture's wall seconds, the bytes its private pool reserved, and its
    replays."""

    def __init__(self, fn, inputs: tuple, dev: torch.device,
                 label: str = ""):
        self.device, self.label = dev, label
        with torch.cuda.device(dev):
            self.inputs = tuple(torch.from_numpy(x).to(dev) for x in inputs)
            t0 = time.perf_counter()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            before = dict(kernels.LAUNCHES)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                reserved = torch.cuda.memory_reserved(dev)
                self.outputs = fn(*self.inputs)
            torch.cuda.synchronize(dev)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.warmup_s = t1 - t0
        self.capture_s = time.perf_counter() - t1
        self.launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                         if v != before[k]}
        self.replays = 0

    def __call__(self, *inputs):
        """Replays on host (or device) tensors shaped as the static inputs;
        returns fresh copies of the outputs, queued on the card's current
        stream."""
        with torch.cuda.device(self.device):
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src)
            self.graph.replay()
            self.replays += 1
            if REC.on:
                count(f"graph.replay[{self.label}]")
                for k, v in self.launches.items():
                    count(f"graph.launches[{k}]", v)
            return _clone(self.outputs)


def _graph(dix: DeviceIndex, key: tuple, fn, inputs) -> DeviceGraph:
    """The graph of `key` on dix, captured from fn on the host arrays
    `inputs` at its first call."""
    g = dix.graphs.get(key)
    if g is None:
        label = key_label(key)
        g = dix.graphs[key] = DeviceGraph(fn, inputs, dix.device, label)
        count(f"graph.capture[{label}]")
    return g


def graphs(dix: DeviceIndex) -> list[tuple[tuple, DeviceGraph]]:
    """The graphs of dix and their keys, in the order they were captured."""
    return list(dix.graphs.items())


def clear(dix: DeviceIndex) -> None:
    """Drops every graph of dix and its pool."""
    dix.graphs.clear()


def map_batch(dix: DeviceIndex, cfg: AlignerConfig, arr, lengths,
              min_read_len: int):
    """map_batch_device of a host batch (uint8 [B, m_pad] reads, int32 [B]
    lengths, numpy) through the graph of its key."""
    def call(reads, lens):
        return map_batch_device(dix, cfg, reads, lens,
                                min_read_len=min_read_len)

    key = graph_key(cfg, *arr.shape, min_read_len)
    return _graph(dix, key, call, (arr, lengths))(
        torch.from_numpy(arr), torch.from_numpy(lengths))


def map_batch_pe(dix: DeviceIndex, cfg: AlignerConfig, a1, l1, a2, l2,
                 min_read_len1: int, min_read_len2: int):
    """map_batch_pe_device of a host pair batch through the graph of its
    key."""
    def call(r1, n1, r2, n2):
        return map_batch_pe_device(dix, cfg, r1, n1, r2, n2,
                                   min_read_len1=min_read_len1,
                                   min_read_len2=min_read_len2)

    key = graph_key(cfg, *a1.shape, min_read_len1, min_read_len2)
    return _graph(dix, key, call, (a1, l1, a2, l2))(
        *(torch.from_numpy(x) for x in (a1, l1, a2, l2)))
