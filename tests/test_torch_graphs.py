"""PyTorch port, CUDA-graph replay of the single-card device calls
(models/graphs.py): the graph key (jit's cache key), which calls replay a
graph and which stay eager, how models/host dispatches between the two,
the CLI's --profile run replaying as any other, the replays and eager
calls counted while the recorder is on, and on the CPU records unchanged
whatever the `graphs` keyword says.  Capture and replay themselves need the
card: chip_smoke.py holds every output leaf of a replay to the eager call's
there."""
import types

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
from bitmapperbs_tpu_torch.models import graphs, host  # noqa: E402
from bitmapperbs_tpu_torch.oracle import paired as opaired  # noqa: E402
from bitmapperbs_tpu_torch.oracle import pipeline as opipeline  # noqa: E402

BS = 32


def cfg(**kw):
    base = dict(max_errors=4, indels=True, read_len_bucket=96,
                batch_size=BS, min_insert=100, max_insert=400)
    base.update(kw)
    return AlignerConfig(**base)


def card_index(sharded: bool = False, card: int = 0):
    """What eligible() and the cache read of an index, as if it were on a
    card."""
    return types.SimpleNamespace(device=torch.device("cuda", card),
                                 sharded=sharded, graphs={})


# ---- the key ----------------------------------------------------------------

def test_key_equal_where_the_seed_slices_agree():
    c = cfg()
    S = c.num_seeds
    assert graphs.graph_key(c, BS, 96, 90) == \
        graphs.graph_key(c, BS, 96, 90 // S * S) == \
        graphs.graph_key(c, BS, 96, 90 // S * S + S - 1)
    assert graphs.graph_key(c, BS, 96, 90) != \
        graphs.graph_key(c, BS, 96, 90 // S * S - 1)
    assert graphs.graph_key(c, BS, 96, 90, 80) == \
        graphs.graph_key(c, BS, 96, 90, 80 // S * S)
    assert graphs.graph_key(c, BS, 96, 90, 80) != \
        graphs.graph_key(c, BS, 96, 90, 90)


@pytest.mark.parametrize("other", [
    dict(cfg=cfg(max_errors=3)), dict(cfg=cfg(non_directional=True)),
    dict(cfg=cfg(seed_ext_max=20)), dict(m_pad=128), dict(rows=BS * 2)])
def test_key_distinct_across_shapes(other):
    c = cfg()
    args = {**dict(cfg=c, rows=BS, m_pad=96), **other}
    assert graphs.graph_key(args["cfg"], args["rows"], args["m_pad"], 90) != \
        graphs.graph_key(c, BS, 96, 90)


# ---- the cache --------------------------------------------------------------

class FakeGraph:
    """Stands for DeviceGraph where no card is: records its capture."""

    def __init__(self, fn, inputs, dev, label=""):
        self.device, self.replays = dev, 0


def test_graphs_live_on_their_index(monkeypatch):
    """A key captures once per index and then hits; another index captures
    its own graph for the same key; clear(dix) drops one index's graphs;
    an index's graphs go with it; a copy of an index moved to another card
    (parallel/shard._place: dataclasses.replace) starts with none."""
    import dataclasses
    import gc
    import weakref

    monkeypatch.setattr(graphs, "DeviceGraph", FakeGraph)
    dix, other, c = card_index(), card_index(), cfg()
    made = [graphs._graph(dix, graphs.graph_key(c, BS, 96, 5 * k), None, ())
            for k in range(3)]
    assert graphs._graph(dix, graphs.graph_key(c, BS, 96, 0), None,
                         ()) is made[0]                      # a hit
    theirs = graphs._graph(other, graphs.graph_key(c, BS, 96, 0), None, ())
    assert theirs is not made[0]
    assert [g for _, g in graphs.graphs(dix)] == made
    graphs.clear(other)
    assert graphs.graphs(other) == [] and len(graphs.graphs(dix)) == 3

    small = upload_index(build_index(random_genome_fasta(
        np.random.default_rng(3), contigs=(800,))))
    g = graphs._graph(small, graphs.graph_key(c, BS, 96, 0), None, ())
    assert graphs.graphs(small) == [(graphs.graph_key(c, BS, 96, 0), g)]
    assert dataclasses.replace(small, n=small.n.clone()).graphs == {}
    gone = weakref.ref(g)
    del small, g
    gc.collect()
    assert gone() is None


def test_capture_and_replay_on_the_index_card(monkeypatch):
    """Warm-up, capture and replay run with the index's card current and
    the capture on a stream made on that card, while another card is
    current; a replay copies its batch into the static inputs and returns
    clones of the static outputs (the fake replay leaves them as the
    capture made them)."""
    import contextlib

    current, log = ["cuda:0"], []

    class Device:
        def __init__(self, d):
            self.d = str(d)

        def __enter__(self):
            self.prev, current[0] = current[0], self.d

        def __exit__(self, *exc):
            current[0] = self.prev

    class Stream:
        def __init__(self, device=None):
            self.device = current[0] if device is None else str(device)

        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            log.append(("replay", current[0]))

    @contextlib.contextmanager
    def capture(graph, pool=None, stream=None):
        log.append(("capture", current[0], stream.device))
        yield

    for name, fake in dict(
            device=Device, Stream=Stream, CUDAGraph=Graph, graph=capture,
            stream=lambda s: contextlib.nullcontext(),
            current_stream=lambda device=None: Stream(device),
            synchronize=lambda device=None: None,
            memory_reserved=lambda device=None: 0).items():
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: self)

    def fn(x):
        log.append(("call", current[0]))
        return {"y": x + 1}

    g = graphs.DeviceGraph(fn, (np.arange(3, dtype=np.int32),),
                           torch.device("cuda", 1))
    out = g(torch.zeros(3, dtype=torch.int32))
    assert log == [("call", "cuda:1"), ("capture", "cuda:1", "cuda:1"),
                   ("call", "cuda:1"), ("replay", "cuda:1")]
    assert current == ["cuda:0"] and g.replays == 1
    assert g.inputs[0].tolist() == [0, 0, 0]      # the batch copied in
    assert out["y"].tolist() == g.outputs["y"].tolist() == [1, 2, 3]
    assert out["y"] is not g.outputs["y"]


# ---- which calls replay -----------------------------------------------------

@pytest.mark.parametrize("dix, c, rows, want", [
    (card_index(), cfg(), BS, True),
    (card_index(), cfg(flat_chunks=1), BS, True),
    (card_index(card=1), cfg(), BS, True),          # not the current card
    (card_index(), cfg(), BS // 2, False),          # a tail batch
    (card_index(), cfg(), 1, False),
    (card_index(), cfg(flat_chunks=2), BS, True),   # lane counts on the card
    (card_index(), cfg(flat_chunks=3), BS, True),
    (card_index(), cfg(compact=False), BS, False),  # the dense re-run
    (card_index(sharded=True), cfg(), BS, False),
    (types.SimpleNamespace(device=torch.device("cpu"), sharded=False), cfg(),
     BS, False),
])
def test_eligible(dix, c, rows, want):
    assert graphs.eligible(dix, c, rows) is want


@pytest.fixture
def dispatch(monkeypatch):
    """models/host's two device calls and the two graph replays replaced by
    recorders: which one a host mapper called, with what rows."""
    calls = []

    def rec(name):
        def fn(dix, c, *a, **k):
            calls.append((name, a[0].shape[0], c.compact))
            return "out"
        return fn

    monkeypatch.setattr(host, "map_batch_device", rec("eager"))
    monkeypatch.setattr(host, "map_batch_pe_device", rec("eager"))
    monkeypatch.setattr(host.device_graphs, "map_batch", rec("graph"))
    monkeypatch.setattr(host.device_graphs, "map_batch_pe", rec("graph"))
    monkeypatch.setattr(host, "_to_device",
                        lambda arr, lengths, dev: (torch.from_numpy(arr),
                                                   torch.from_numpy(lengths)))
    return calls


@pytest.mark.parametrize("pe", [False, True])
@pytest.mark.parametrize("flag", [True, False])
def test_host_dispatch(dispatch, pe, flag):
    """Full batches replay a graph when the keyword allows it; tail batches
    and the dense re-run stay eager; the keyword False keeps all eager."""
    dix = card_index()
    arr = np.zeros((BS, 96), np.uint8)
    ln = np.full(BS, 90, np.int32)
    map_fn, dense_fn = host._mappers(dix, cfg(), None, flag, pe=pe)
    if pe:
        run = lambda fn, a, n: fn(a, n, a, n, 90, 90)  # noqa: E731
    else:
        run = lambda fn, a, n: fn(a, n, 90)            # noqa: E731
    run(map_fn, arr, ln)
    run(map_fn, arr[:4], ln[:4])
    run(dense_fn, arr, ln)
    full = "graph" if flag else "eager"
    assert dispatch == [(full, BS, True), ("eager", 4, True),
                        ("eager", BS, False)]


@pytest.mark.parametrize("pe", [False, True])
def test_eager_calls_counted_by_reason(dispatch, pe):
    """While the recorder is on, one card's calls that do not replay are
    counted by reason: a tail batch, the dense re-run, and every call with
    graphs off; a replayed call is not an eager one."""
    from bitmapperbs_tpu_torch.utils.profiling import REC

    arr = np.zeros((BS, 96), np.uint8)
    ln = np.full(BS, 90, np.int32)
    REC.start()
    try:
        for flag in (True, False):
            map_fn, dense_fn = host._mappers(card_index(), cfg(), None,
                                             flag, pe=pe)
            if pe:
                run = lambda fn, a, n: fn(a, n, a, n, 90, 90)  # noqa: E731
            else:
                run = lambda fn, a, n: fn(a, n, 90)            # noqa: E731
            run(map_fn, arr, ln)
            run(map_fn, arr[:4], ln[:4])
            run(dense_fn, arr, ln)
    finally:
        snap = REC.stop()
    assert snap["counters"] == {"eager.tail": 1, "eager.dense": 2,
                                "eager.ineligible": 2}
    assert [d[0] for d in dispatch].count("graph") == 1


@pytest.mark.parametrize("dix, c, rows, graphs_on, want", [
    (card_index(), cfg(), BS // 2, True, "eager.tail"),
    (card_index(), cfg(compact=False), BS, True, "eager.dense"),
    (card_index(), cfg(compact=False), BS // 2, False, "eager.dense"),
    (card_index(), cfg(), BS, False, "eager.ineligible"),
    (card_index(sharded=True), cfg(), BS // 2, True, "eager.ineligible"),
    (types.SimpleNamespace(device=torch.device("cpu"), sharded=False), cfg(),
     BS, True, "eager.ineligible"),
])
def test_eager_reason(dix, c, rows, graphs_on, want):
    assert graphs.eager_reason(dix, c, rows, graphs_on) == want


def test_replays_counted_per_key_and_kernel(monkeypatch):
    """While the recorder is on: a capture counted once per key, each
    replay per key, and each replay's captured launches per kernel (what
    ops/kernels.LAUNCHES cannot see); off, only DeviceGraph.replays
    counts."""
    import contextlib

    from bitmapperbs_tpu_torch.utils.profiling import REC

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    key = graphs.graph_key(cfg(), BS, 96, 90)
    label = graphs.key_label(key)
    assert label == f"e4/{BS}x96/q{90 // cfg().num_seeds}"
    assert graphs.key_label(graphs.graph_key(cfg(), BS, 96, 90, 60)) == \
        f"{label},{60 // cfg().num_seeds}"
    real = graphs.DeviceGraph
    monkeypatch.setattr(graphs, "DeviceGraph", FakeGraph)
    REC.start()
    try:
        dix = card_index()
        assert graphs._graph(dix, key, None, ()) is \
            graphs._graph(dix, key, None, ())
        g = object.__new__(real)          # a captured graph, no card
        g.device, g.label, g.inputs, g.replays = "cuda:0", label, (), 0
        g.outputs = {"y": torch.zeros(2)}
        g.graph = types.SimpleNamespace(replay=lambda: None)
        g.launches = {"fm_search": 1, "verify_fused_gather": 2}
        g()
        g()
    finally:
        snap = REC.stop()
    g()
    assert g.replays == 3
    assert snap["counters"] == {
        f"graph.capture[{label}]": 1, f"graph.replay[{label}]": 2,
        "graph.launches[fm_search]": 2,
        "graph.launches[verify_fused_gather]": 4}


@pytest.mark.parametrize("pe", [False, True])
def test_mesh_mappers_stay_eager(dispatch, pe):
    """A mesh's mappers (parallel/shard.CliMappers) are used as they are:
    the host never replays a graph for them."""
    mesh = types.SimpleNamespace(se="se", se_dense="se_dense", pe="pe",
                                 pe_dense="pe_dense")
    want = ("pe", "pe_dense") if pe else ("se", "se_dense")
    assert host._mappers(card_index(), cfg(), mesh, True, pe=pe) == want
    assert dispatch == []


def test_profile_run_stays_eager(tmp_path, monkeypatch):
    """The --profile run no longer stays eager: the CLI passes graphs=True
    to the host with and without --profile, SE and PE, so the trace shows
    the graphed path."""
    from bitmapperbs_tpu_torch import cli

    fa = random_genome_fasta(np.random.default_rng(5), contigs=(3000,))
    (tmp_path / "ref.fa").write_text(fa)
    genome = parse_fasta(fa)
    sims = simulate_reads(genome, 8, read_len=80, seed=1)
    write_fastq(tmp_path / "r.fq", [s.codes for s in sims])
    pairs = simulate_pairs(genome, 8, read_len=80, seed=2, min_insert=150,
                           max_insert=300)
    for k in (0, 1):
        write_fastq(tmp_path / f"p{k}.fq", [p[k].codes for p in pairs],
                    qnames=[f"q{i}" for i in range(len(pairs))])
    assert cli.main(["index", str(tmp_path / "ref.fa")]) == 0
    seen = []
    for name in ("map_batch", "map_batch_pe"):
        real = getattr(host, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.append((_name, k["graphs"]))
            return _real(*a, **k)
        monkeypatch.setattr(host, name, spy)
    base = ["search", str(tmp_path / "ref.fa"), "--platform", "cpu"]
    se = ["--seq", str(tmp_path / "r.fq")]
    pe = ["--pe", "--seq1", str(tmp_path / "p0.fq"), "--seq2",
          str(tmp_path / "p1.fq"), "--min", "100", "--max", "400"]
    for mode, extra in (("se", se), ("pe", pe)):
        for prof in (False, True):
            out = tmp_path / f"{mode}{prof}.sam"
            args = [*base, *extra, "-o", str(out)]
            if prof:
                args += ["--profile", str(tmp_path / "prof")]
            assert cli.main(args) == 0
    assert seen == [("map_batch", True), ("map_batch", True),
                    ("map_batch_pe", True), ("map_batch_pe", True)]


# ---- on the CPU the keyword changes nothing ---------------------------------

@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(71)
    idx = build_index(random_genome_fasta(rng, contigs=(5000, 2500)))
    return idx, upload_index(idx)


@pytest.mark.parametrize("pe", [False, True])
def test_cpu_records_unchanged(small, pe):
    """map_batch / map_batch_pe on CPU tensors: a full batch and a tail
    batch, records equal with graphs on and off and to the oracle's; no
    graph is captured."""
    idx, dix = small
    c = cfg(paired=pe)
    if pe:
        items = [(a.codes, b.codes) for a, b in simulate_pairs(
            idx.genome, BS + 5, read_len=80, seed=72, min_insert=150,
            max_insert=350, sub_rate=0.01, indel_rate=0.005)]
        fn, oracle = host.map_batch_pe, opaired.map_batch_pe
    else:
        items = [s.codes for s in simulate_reads(
            idx.genome, BS + 5, read_len=90, seed=73, sub_rate=0.01,
            indel_rate=0.005)]
        fn, oracle = host.map_batch, opipeline.map_batch_se
    on = [r.line() for r in fn(idx, dix, c, items, graphs=True)]
    off = [r.line() for r in fn(idx, dix, c, items, graphs=False)]
    assert on == off
    assert on == [r.line() for r in oracle(idx, c, items)]
    assert graphs.graphs(dix) == []
