"""PyTorch port CLI, `--resume` and its cursor file (analogs of
tests/test_cli.py::test_cursor_resume and tests/test_fault_injection.py).

A run writes `<out>.cursor` after every written group; SIGKILL it once the
cursor has advanced, then `--resume`: the output must equal an
uninterrupted run of the port and the reference CLI's output for the same
arguments (records; for BAM the decompressed records), for single-end SAM
and BAM, paired-end, and paired-end under record-strided two-host
sharding.  The cursor is the reference's JSON, so a run killed under the
reference resumes under the port.  All runs on the CPU (`--platform cpu`).
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bitmapperbs_tpu.cli import main as jmain  # noqa: E402
from bitmapperbs_tpu.index.build import parse_fasta  # noqa: E402
from bitmapperbs_tpu.io.fastq import write_fastq  # noqa: E402
from bitmapperbs_tpu.parallel import multihost as jmultihost  # noqa: E402
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,  # noqa: E402
                                            simulate_pairs, simulate_reads)
from bitmapperbs_tpu_torch.cli import main  # noqa: E402
from bitmapperbs_tpu_torch.parallel import multihost  # noqa: E402
from tests.test_bam import decode_bam  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS, N_PAIRS = 60, 40


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_resume")
    fa = random_genome_fasta(np.random.default_rng(8), contigs=(3000, 1200))
    (d / "ref.fa").write_text(fa)
    g = parse_fasta(fa)
    sims = simulate_reads(g, N_READS, read_len=64, seed=6, sub_rate=0.01,
                          indel_rate=0.005)
    write_fastq(d / "reads.fq", [s.codes for s in sims],
                [f"r{i}" for i in range(N_READS)], [s.qual for s in sims])
    prs = simulate_pairs(g, N_PAIRS, read_len=60, seed=14, sub_rate=0.01,
                         min_insert=120, max_insert=300)
    for mate in (0, 1):
        write_fastq(d / f"r{mate + 1}.fq", [p[mate].codes for p in prs],
                    [f"p{i}" for i in range(N_PAIRS)],
                    [p[mate].qual for p in prs])
    assert main(["index", str(d / "ref.fa")]) == 0
    return d


def se_args(d, batch=6):
    return ["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
            "--batch-size", str(batch), "--read-bucket", "64"]


def pe_args(d):
    return ["search", str(d / "ref.fa"), "--seq1", str(d / "r1.fq"),
            "--seq2", str(d / "r2.fq"), "--pe", "--min", "100", "--max",
            "350", "--batch-size", "4", "--read-bucket", "64"]


def records(path):
    return [ln for ln in open(path).read().splitlines()
            if ln and not ln.startswith("@")]


def bam_records(path):
    _, refs, recs = decode_bam(open(path, "rb").read())
    return refs, recs


def spawn(code, args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen([sys.executable, "-c", code] + args, env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


PORT = ("import sys; from bitmapperbs_tpu_torch.cli import main; "
        "sys.exit(main(sys.argv[1:]))")
# two hosts one after the other: no process group, each its own shard
PORT_STUB = ("import sys; from bitmapperbs_tpu_torch.parallel import "
             "multihost; multihost.init_distributed = lambda c, n, p: "
             "(p or 0, n); from bitmapperbs_tpu_torch.cli import main; "
             "sys.exit(main(sys.argv[1:]))")
REFERENCE = ("import jax, sys; jax.config.update('jax_platforms', 'cpu'); "
             "from bitmapperbs_tpu.cli import main; "
             "sys.exit(main(sys.argv[1:]))")


def kill_once_cursor_advances(code, args, out):
    """Run the CLI in a subprocess and SIGKILL it (its exact PID) once its
    cursor exists; the output must then be incomplete."""
    cursor = str(out) + ".cursor"
    p = spawn(code, args)
    deadline = time.time() + 300
    while not os.path.exists(cursor):
        if p.poll() is not None:
            pytest.fail("run finished before it could be killed: "
                        + p.stderr.read().decode()[-2000:])
        assert time.time() < deadline, "no cursor within 300 s"
        time.sleep(0.02)
    os.kill(p.pid, signal.SIGKILL)
    p.wait(timeout=60)
    assert os.path.exists(cursor), "cursor missing after the kill"
    cur = json.load(open(cursor))
    assert set(cur) == {"record", "offset", "offset2", "out_pos"}, cur
    assert cur["record"] > 0 and cur["out_pos"] <= os.path.getsize(out)
    return cur


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_se_sigkill_and_resume(data, fmt):
    d = data
    base = se_args(d) + ["--platform", "cpu"]
    full, crash = d / f"se_full.{fmt}", d / f"se_crash.{fmt}"
    assert main(base + ["-o", str(full)]) == 0
    assert not os.path.exists(str(full) + ".cursor")  # dropped at the end
    cur = kill_once_cursor_advances(PORT, base + ["-o", str(crash)], crash)
    assert cur["record"] < N_READS
    assert main(base + ["-o", str(crash), "--resume"]) == 0
    assert not os.path.exists(str(crash) + ".cursor")
    ref = d / f"se_ref.{fmt}"
    assert jmain(se_args(d) + ["--single-device", "-o", str(ref)]) == 0
    if fmt == "sam":
        got = records(crash)
        assert got == records(full) == records(ref)
        assert len(got) == N_READS
        # one header: resume appended without writing another
        assert sum(ln.startswith("@HD") for ln in open(crash)) == 1
    else:
        got = bam_records(crash)
        assert got == bam_records(full) == bam_records(ref)
        assert len(got[1]) == N_READS


def test_pe_sigkill_and_resume(data):
    d = data
    base = pe_args(d) + ["--platform", "cpu"]
    full, crash = d / "pe_full.sam", d / "pe_crash.sam"
    assert main(base + ["-o", str(full)]) == 0
    cur = kill_once_cursor_advances(PORT, base + ["-o", str(crash)], crash)
    assert cur["offset2"] > 0
    assert main(base + ["-o", str(crash), "--resume"]) == 0
    assert not os.path.exists(str(crash) + ".cursor")
    ref = d / "pe_ref.sam"
    assert jmain(pe_args(d) + ["--single-device", "-o", str(ref)]) == 0
    assert records(crash) == records(full) == records(ref)
    assert len(records(crash)) == 2 * N_PAIRS


def test_pe_sharded_sigkill_and_resume(data, monkeypatch):
    """Record-strided two-host sharding: host 0 killed and resumed, host 1
    uninterrupted; the cursor advances by the unfiltered batch, so each
    shard equals the uninterrupted port's and the reference's shard."""
    d = data
    base = pe_args(d) + ["--dist-hosts", "2", "--dist-shard", "records"]
    out = d / "mh.sam"
    shard0 = d / "mh.shard0.sam"
    kill_once_cursor_advances(
        PORT_STUB, base + ["--platform", "cpu", "-o", str(out),
                           "--dist-host-id", "0"], shard0)
    monkeypatch.setattr(multihost, "init_distributed",
                        lambda c, n, p: (p or 0, n))
    monkeypatch.setattr(jmultihost, "init_distributed",
                        lambda c, n, p: (p or 0, n))
    assert main(base + ["--platform", "cpu", "-o", str(out),
                        "--dist-host-id", "0", "--resume"]) == 0
    assert main(base + ["--platform", "cpu", "-o", str(out),
                        "--dist-host-id", "1"]) == 0
    for h in (0, 1):
        assert main(base + ["--platform", "cpu", "-o", str(d / "mhf.sam"),
                            "--dist-host-id", str(h)]) == 0
        assert jmain(base + ["--single-device", "-o", str(d / "mhr.sam"),
                             "--dist-host-id", str(h)]) == 0
        got = records(d / f"mh.shard{h}.sam")
        assert got == records(d / f"mhf.shard{h}.sam") \
            == records(d / f"mhr.shard{h}.sam")
        assert len(got) == N_PAIRS          # 20 pairs, two records each
        assert not os.path.exists(str(d / f"mh.shard{h}.sam") + ".cursor")


def test_resume_truncates_unacknowledged_output(data):
    """A crash between the output flush and the cursor write leaves records
    past the cursor: resume truncates them instead of duplicating."""
    d = data
    base = se_args(d, batch=8) + ["--platform", "cpu"]
    full, out = d / "tr_full.sam", d / "tr.sam"
    assert main(base + ["-o", str(full)]) == 0
    lines = open(full).read().splitlines(keepends=True)
    hdr = [ln for ln in lines if ln.startswith("@")]
    recs = [ln for ln in lines if not ln.startswith("@")]
    with open(out, "w") as f:                 # two batches written ...
        f.writelines(hdr + recs[:16])
    acked = sum(len(ln) for ln in hdr + recs[:8])   # ... one acknowledged
    fq = open(d / "reads.fq", "rb").read().splitlines(keepends=True)
    json.dump({"record": 8, "offset": sum(len(ln) for ln in fq[:32]),
               "offset2": 0, "out_pos": acked},
              open(str(out) + ".cursor", "w"))
    assert main(base + ["-o", str(out), "--resume"]) == 0
    assert records(out) == [ln.rstrip("\n") for ln in recs]


def test_cursor_resume_without_out_pos(data):
    """tests/test_cli.py::test_cursor_resume's crafted cursor: record and
    offset only (no out_pos, no offset2); --resume appends after it."""
    d = data
    base = se_args(d, batch=10) + ["--platform", "cpu"]
    full, out = d / "cr_full.sam", d / "cr.sam"
    assert main(base + ["-o", str(full)]) == 0
    lines = open(full).read().splitlines(keepends=True)
    hdr = [ln for ln in lines if ln.startswith("@")]
    body = [ln for ln in lines if not ln.startswith("@")]
    with open(out, "w") as f:
        f.writelines(hdr + body[:10])
    fq = open(d / "reads.fq", "rb").read().splitlines(keepends=True)
    json.dump({"record": 10, "offset": sum(len(ln) for ln in fq[:40])},
              open(str(out) + ".cursor", "w"))
    assert main(base + ["-o", str(out), "--resume"]) == 0
    assert records(out) == records(full)
    # without a cursor, --resume is a fresh run
    assert main(base + ["-o", str(d / "cr2.sam"), "--resume"]) == 0
    assert records(d / "cr2.sam") == records(full)


def test_cursor_present_mid_run_and_gone_at_the_end(data):
    """The cursor is written whether or not --resume was given, replaced
    atomically (no .tmp left behind), and deleted once the run completes."""
    d = data
    out = d / "mid.sam"
    args = se_args(d) + ["--platform", "cpu", "-o", str(out)]
    cur = kill_once_cursor_advances(PORT, args, out)
    assert not os.path.exists(str(out) + ".cursor.tmp")
    acked = open(out).read()[:cur["out_pos"]]
    assert acked.endswith("\n") and len(
        [ln for ln in acked.splitlines() if not ln.startswith("@")]) \
        == cur["record"]
    assert main(args) == 0                    # a fresh run overwrites it all
    assert not os.path.exists(str(out) + ".cursor")
    assert len(records(out)) == N_READS


def test_reference_cursor_resumes_under_the_port(data):
    """A run killed under the reference package (its own cursor file)
    resumes under the port: the records equal the reference's
    uninterrupted run."""
    d = data
    base = se_args(d) + ["--oracle"]
    want = d / "x_ref.sam"
    assert jmain(base + ["-o", str(want)]) == 0
    out = d / "x.sam"
    cur = kill_once_cursor_advances(REFERENCE, base + ["-o", str(out)], out)
    assert cur["record"] < N_READS
    assert main(base + ["-o", str(out), "--resume"]) == 0
    assert records(out) == records(want)
    assert not os.path.exists(str(out) + ".cursor")
