"""PyTorch port, multi-host runs (analogs of tests/test_multihost.py):
record-strided and byte-range shard plans, shard paths, the global stats
all_reduce, the .gz refusal of byte ranges, and real two-process runs of
the port's CLI over gloo on 127.0.0.1 whose per-host SAM shards equal the
reference CLI's shards for the same host split, file by file."""
import ast
import gzip
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bitmapperbs_tpu.cli import main as jmain  # noqa: E402
from bitmapperbs_tpu.index.build import parse_fasta  # noqa: E402
from bitmapperbs_tpu.parallel import multihost as jmultihost  # noqa: E402
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,  # noqa: E402
                                            simulate_reads)
from bitmapperbs_tpu_torch.cli import main  # noqa: E402
from bitmapperbs_tpu_torch.io.fastq import (FastqReader,  # noqa: E402
                                            read_pairs, write_fastq)
from bitmapperbs_tpu_torch.io.stats import MapStats  # noqa: E402
from bitmapperbs_tpu_torch.parallel import multihost  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = 36


def test_host_shard_partition():
    H = 3
    shards = [multihost.HostShard(h, H) for h in range(H)]
    n = 100
    codes = [np.zeros(2, np.uint8) + i for i in range(n)]
    qnames = [f"r{i}" for i in range(n)]
    quals = [""] * n
    seen = []
    for lo in range(0, n, 7):             # batches of 7, global start record
        hi = min(lo + 7, n)
        for sh in shards:
            c, q, _ = sh.filter_batch(codes[lo:hi], qnames[lo:hi],
                                      quals[lo:hi], lo)
            assert all(int(x[1:]) % H == sh.process_id for x in q)
            seen.extend(q)
    assert sorted(seen, key=lambda s: int(s[1:])) == qnames   # exact cover


def test_byte_range_plan_exact_cover(tmp_path):
    """Plans tile the file at record boundaries even with '@'-leading
    quality lines and varied read lengths; the per-host range readers
    concatenate to the whole record set in order."""
    rng = np.random.default_rng(5)
    n = 53
    reads = [rng.integers(0, 4, int(rng.integers(40, 90))).astype(np.uint8)
             for _ in range(n)]
    quals = [("@" if i % 2 else "I") * len(r) for i, r in enumerate(reads)]
    fq = tmp_path / "r.fq"
    write_fastq(str(fq), reads, [f"r{i}" for i in range(n)], quals)
    size = os.path.getsize(fq)
    for H in (2, 3, 5):
        plans = [multihost.plan_byte_range(str(fq), h, H) for h in range(H)]
        assert [p.__dict__ for p in plans] == [
            jmultihost.plan_byte_range(str(fq), h, H).__dict__
            for h in range(H)]
        assert plans[0].offset == 0 and plans[-1].limit_offset == size
        for h in range(H - 1):
            assert plans[h].limit_offset == plans[h + 1].offset
            assert (plans[h].start_record + plans[h].n_records
                    == plans[h + 1].start_record)
        assert sum(p.n_records for p in plans) == n
        got = []
        for p in plans:
            for b in FastqReader(str(fq), batch_size=7,
                                 resume_offset=p.offset,
                                 resume_record=p.start_record,
                                 limit_offset=p.limit_offset):
                got.extend(b.qnames)
        assert got == [f"r{i}" for i in range(n)]


def test_byte_range_plan_pe_alignment(tmp_path):
    """PE plans align mate 2 by record count even where the mate files have
    other byte layouts (other read lengths)."""
    rng = np.random.default_rng(6)
    n = 31
    f1, f2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    write_fastq(str(f1), [rng.integers(0, 4, 80).astype(np.uint8)
                          for _ in range(n)], [f"p{i}" for i in range(n)])
    write_fastq(str(f2), [rng.integers(0, 4, 40).astype(np.uint8)
                          for _ in range(n)], [f"p{i}" for i in range(n)])
    got = []
    for h in range(3):
        p = multihost.plan_byte_range(str(f1), h, 3, path2=str(f2))
        assert p.offset2 == jmultihost.plan_byte_range(
            str(f1), h, 3, path2=str(f2)).offset2
        for b1, b2 in read_pairs(str(f1), str(f2), batch_size=4,
                                 resume_offsets=(p.offset, p.offset2),
                                 resume_record=p.start_record,
                                 limit_records=p.n_records):
            assert b1.qnames == b2.qnames
            got.extend(b1.qnames)
    assert got == [f"p{i}" for i in range(n)]


def test_shard_path():
    assert multihost.shard_path("out.sam", 0, 1) == "out.sam"
    assert multihost.shard_path("out.sam", 2, 4) == "out.shard2.sam"
    assert multihost.shard_path("o", 1, 2) == "o.shard1.sam"


def test_global_stats_single_process():
    """No process group: this host's own counters, and init_distributed on
    one host joins none."""
    assert multihost.init_distributed(None, 1, None) == (0, 1)
    assert not torch.distributed.is_initialized()
    st = MapStats(total=10, mapped=8, unique=7, ambiguous=1, unmapped=2,
                  proper_pairs=3, overflow_reads=1)
    g = multihost.global_stats(st)
    assert g == {"total": 10, "mapped": 8, "unique": 7, "ambiguous": 1,
                 "unmapped": 2, "proper_pairs": 3, "overflow_reads": 1}


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(code, args=()):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def test_global_stats_two_processes():
    """One all_reduce over gloo sums the seven counters of two processes."""
    port = free_port()
    code = (
        "import json, sys\n"
        "from bitmapperbs_tpu_torch.io.stats import MapStats\n"
        "from bitmapperbs_tpu_torch.parallel import multihost as mh\n"
        "r = int(sys.argv[1])\n"
        f"print(mh.init_distributed('127.0.0.1:{port}', 2, r))\n"
        "st = MapStats(total=10 + r, mapped=8, unique=7 - r, ambiguous=1,\n"
        "              unmapped=2 + r, proper_pairs=r, overflow_reads=5)\n"
        "print(json.dumps(mh.global_stats(st)))\n"
        "mh.finalize_distributed()\n")
    procs = [spawn(code, [str(r)]) for r in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
        outs.append(out.decode().splitlines())
    for r, lines in enumerate(outs):
        assert lines[0] == f"({r}, 2)"
        assert json.loads(lines[1]) == {
            "total": 21, "mapped": 16, "unique": 13, "ambiguous": 2,
            "unmapped": 5, "proper_pairs": 1, "overflow_reads": 10}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mh")
    fa = random_genome_fasta(np.random.default_rng(4), contigs=(3000,))
    (d / "ref.fa").write_text(fa)
    sims = simulate_reads(parse_fasta(fa), N_READS, read_len=64, seed=5,
                          sub_rate=0.01)
    write_fastq(str(d / "reads.fq"), [s.codes for s in sims],
                [f"r{i}" for i in range(N_READS)], ["I" * 64] * N_READS)
    assert main(["index", str(d / "ref.fa")]) == 0
    return d


def sam_records(path):
    return [ln for ln in open(path).read().splitlines()
            if ln and not ln.startswith("@")]


def base_args(d, fq="reads.fq"):
    return ["search", str(d / "ref.fa"), "--seq", str(d / fq),
            "--batch-size", "8", "--read-bucket", "64"]


def test_byte_shard_rejects_gz(dataset, monkeypatch):
    """Byte ranges are planned on uncompressed offsets: on a .gz they would
    drop or duplicate records silently, so `bytes` is refused; `auto`
    takes record striding there."""
    d = dataset
    (d / "reads.fq.gz").write_bytes(gzip.compress((d / "reads.fq")
                                                  .read_bytes()))
    monkeypatch.setattr(multihost, "init_distributed",
                        lambda c, n, p: (p or 0, n))
    args = base_args(d, "reads.fq.gz") + [
        "-o", str(d / "gz.sam"), "--platform", "cpu", "--dist-hosts", "2",
        "--dist-host-id", "0"]
    with pytest.raises(SystemExit, match="uncompressed"):
        main(args + ["--dist-shard", "bytes"])
    assert main(args + ["--dist-shard", "auto"]) == 0
    got = sam_records(d / "gz.shard0.sam")
    assert [ln.split("\t")[0] for ln in got] == [
        f"r{i}" for i in range(0, N_READS, 2)]


@pytest.mark.parametrize("mode", ["bytes", "records"])
def test_two_process_gloo_cli(dataset, monkeypatch, mode):
    """Two real processes of the port's CLI joined over gloo on 127.0.0.1:
    each host's SAM shard equals the reference CLI's shard for the same
    host split, the shards together are the single-host record set, and
    (records mode, where the CLI prints them) the global counters equal
    the single-host stats."""
    d = dataset
    common = base_args(d) + ["--dist-shard", mode]
    single = d / f"single_{mode}.sam"
    assert main(base_args(d) + ["--platform", "cpu", "-o", str(single),
                                "--stats-json", str(d / "single.json")]) == 0
    port = free_port()
    code = ("import sys; from bitmapperbs_tpu_torch.cli import main; "
            "sys.exit(main(sys.argv[1:]))")
    procs = [spawn(code, common + [
        "--platform", "cpu", "-o", str(d / f"mh_{mode}.sam"),
        "--dist-hosts", "2", "--dist-host-id", str(h),
        "--dist-coordinator", f"127.0.0.1:{port}"]) for h in (0, 1)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()
        errs.append(err.decode())
        assert f"({mode})" in errs[-1]
    monkeypatch.setattr(jmultihost, "init_distributed",
                        lambda c, n, p: (p or 0, n))
    merged = []
    for h in (0, 1):
        assert jmain(common + ["--single-device", "-o",
                               str(d / f"ref_{mode}.sam"), "--dist-hosts",
                               "2", "--dist-host-id", str(h)]) == 0
        got = sam_records(d / f"mh_{mode}.shard{h}.sam")
        assert got == sam_records(d / f"ref_{mode}.shard{h}.sam")
        assert 0 < len(got) < N_READS
        merged += got
    assert sorted(merged) == sorted(sam_records(single))
    if mode == "records":
        want = json.loads((d / "single.json").read_text())
        for err in errs:
            line = [ln for ln in err.splitlines()
                    if "global (all 2 hosts)" in ln]
            assert len(line) == 1, err
            g = ast.literal_eval(line[0].split("hosts): ", 1)[1])
            for k, v in g.items():
                assert v == want[k], (k, g, want)
