"""The harness end to end on the CPU (the port's plain PyTorch path, a tiny
genome): argument handling, the result's shape, and `correct` coming out
false when the timed path is broken underneath."""
import contextlib
import json
import subprocess
import sys

import pytest

from wgbs_bench import cells, run
from wgbs_bench.tests.helpers import tiny_run


def test_arguments_are_required():
    with pytest.raises(SystemExit):
        run.parse(["--workload", "x"])
    o = run.parse(["--workload", "x", "--seed", str(2**31 + 5),
                   "--seconds", "10", "--trace", "1"])
    assert (o.seed, o.seconds, o.trace) == (2**31 + 5, 10.0, 1)


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing on
    standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "-m", "wgbs_bench", "--workload",
                        "se150-dir.bulk", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=cells.ROOT,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("workload", ["tiny-pe.wgbs", "tiny-se.bulk"])
def test_result_shape(tiny, workload):
    result, info = tiny_run(tiny, workload)
    chk = info["check"]
    # the port writes the PE cell's G->A gapped records wrong (PERF.md,
    # open questions), so there `correct` is only held to the check's verdict
    assert result["correct"] is (chk["mismatched_records"] == 0
                                 and chk["missing_records"] == 0
                                 and result["failed"] == 0), chk
    if workload == "tiny-se.bulk":
        assert result["correct"] is True, chk
    assert list(result)[-1] == "check"
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"}
               for v in result["metrics"].values())
    assert result["attempted"] > 0 and result["failed"] == 0
    assert info["check"]["compared"] > 0
    assert set(result["check"]) == {"mismatched_records", "missing_records"}
    json.dumps(result)


def test_traced_run_reports_host_layers(tiny):
    """A traced run on the CPU reports the span metrics; the device ones
    (no trace of a card) are left out, not reported as 0."""
    result, _ = tiny_run(tiny, "tiny-se.bulk", trace=1, seconds=2.0)
    assert set(result["metrics"]) == {"io.wait_share",
                                      "host.device_wait_share",
                                      "host.cpu_ms_per_kread",
                                      "host.call_p95_ms"}
    assert result["correct"] is True


def _faulty(mutate):
    """A fault planted in models.host.map_batch / map_batch_pe: `mutate`
    gets each call's records and returns what the call hands back."""
    from bitmapperbs_tpu_torch.models import host

    @contextlib.contextmanager
    def faults():
        real = {n: getattr(host, n) for n in ("map_batch", "map_batch_pe")}

        def wrap(fn):
            return lambda *a, **kw: mutate(fn(*a, **kw))

        try:
            for n, fn in real.items():
                setattr(host, n, wrap(fn))
            yield
        finally:
            for n, fn in real.items():
                setattr(host, n, fn)
    return faults


def _shift_pos(recs):
    for r in recs:
        if r.pos:
            r.pos += 1
    return recs


def _half(recs):
    return recs[:len(recs) // 2]


@pytest.mark.parametrize("workload", ["tiny-pe.wgbs", "tiny-se.bulk"])
@pytest.mark.parametrize("fault", [_shift_pos, _half],
                         ids=["answer_altered", "half_the_batch_left_out"])
def test_faults_make_it_not_correct(tiny, workload, fault):
    result, info = tiny_run(tiny, workload, faults=_faulty(fault))
    assert result["correct"] is False
    chk = info["check"]
    assert chk["mismatched_records"] + chk["missing_records"] \
        + result["failed"] > 0


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the command fails and prints no result."""
    import shutil

    shutil.copytree(cells.PKG, tmp_path / "wgbs_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(cells.ROOT + "/BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "wgbs_bench", "--workload",
                        "se150-dir.bulk", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_profiled_stretch_is_left_out_of_the_spans():
    """window() with a traced device: the spans pause from the profiler's
    start to its stop, and that stretch's seconds, CPU and reads are handed
    back, so that the span and CPU metrics leave it out."""
    import time

    import torch

    from wgbs_bench.trace import Spans

    class Stub:
        def __init__(self):
            self.counts = run.Counts()

        def step(self):
            with spans.span("map"):
                time.sleep(0.02)
            self.counts.reads += 100
            return 100

    spans, loop = Spans(True), Stub()
    clock = iter(range(10**6))
    t0, t1, sub = run.window(loop, 4.0, spans, torch.device("cpu"),
                             lambda: float(next(clock)))
    assert sub["prof"] is not None and sub["calls"] > 0
    assert 0 < sub["paused_s"] < t1 - t0
    assert sub["paused_cpu_s"] == 1.0           # one step of the stub clock
    assert sub["paused_reads"] >= sub["reads"] > 0
    assert len(spans.call_walls) == loop.counts.reads // 100 \
        - sub["paused_reads"] // 100
