"""PyTorch port against the benchmark's independent reference
(`wgbs_bench/reference`: numpy only, written from SAM v1 and Bismark, none
of either package's code): on the 350 kbp world of the benchmark's CPU tests
with 0.5 % indels, directional pairs and PBAT single-end reads give the
reference's records, line for line, through the port's numpy oracle, its
plain PyTorch path and its finalize pool at -t 2; the G->A hits with an
indel among them, whose CIGAR follows the genome strand; each SAM v1 mate
field rule; the harness's tiny PE cell coming out correct; the PE and G->A
counters of a `--profile` run; and the native finalizer (where its library
is built) against the numpy one on those records."""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

from sam_v1 import mend_mates  # noqa: E402
from wgbs_bench import genome as genome_mod, traffic  # noqa: E402
from wgbs_bench.reference import index as ref_index  # noqa: E402
from wgbs_bench.reference import map_pairs, map_reads  # noqa: E402
from wgbs_bench.reference.config import Spec  # noqa: E402
from wgbs_bench.tests.helpers import TINY_GENOME  # noqa: E402

from bitmapperbs_tpu_torch.config import AlignerConfig  # noqa: E402

MAPQ = {"mapq_by_gap": [0, 10, 20, 30], "mapq_max": 42}
METH = {"cpg": 0.75, "other": 0.01}
PE = {"mode": "pe", "pool": 96, "read_len": 150, "insert": [150, 700],
      "meth": METH, "sub_rate": 0.01, "indel_rate": 0.005,
      "foreign_share": 0.15, "repeat_anchored_share": 0.4,
      "repeat_kind": "tandem", "repeat_insert": [300, 480]}
SE = {"mode": "se", "pool": 128, "read_len": 141, "clip5": 9,
      "protocols": ["OT", "OB", "CTOT", "CTOB"], "meth": METH,
      "sub_rate": 0.01, "indel_rate": 0.005, "foreign_share": 0.15,
      "trim": {"keep": 0.8, "min": 20, "max": 140}}
CONFIGS = {
    "pe": AlignerConfig(max_errors=4, paired=True, max_insert=500,
                        seed_ext_max=20, max_candidates=128, batch_size=32),
    "pbat_se": AlignerConfig(max_errors=4, non_directional=True,
                             batch_size=64),
}
SEEDS = {"pe": 2**31 + 12, "pbat_se": 2**31 + 13}


def spec_of(cfg) -> Spec:
    return Spec(**{f.name: getattr(cfg, f.name)
                   for f in dataclasses.fields(Spec) if hasattr(cfg, f.name)},
                **MAPQ)


def fields(line: str) -> list[str]:
    return line.split("\t")


def ga_gapped(line: str) -> bool:
    f = fields(line)
    return "XR:Z:GA" in f[11:] and any(op in f[5] for op in "ID")


@pytest.fixture(scope="module")
def world():
    """The tiny genome, the port's index of it (host and CPU device), and
    the reference's own view of it."""
    from bitmapperbs_tpu_torch.index.build import build_index
    from bitmapperbs_tpu_torch.index.device import upload_index

    g = genome_mod.draw(TINY_GENOME)
    idx = build_index(g.fasta())
    return g, idx, upload_index(idx, torch.device("cpu")), ref_index.Index(
        ref_index.Genome(g.names, g.contigs))


@pytest.fixture(scope="module")
def wanted(world):
    """{mode: (reads or pairs, names, the reference's lines)}."""
    out = {}
    for mode, t in (("pe", PE), ("pbat_se", SE)):
        pool = traffic.make_pool(t, world[0], SEEDS[mode])
        names = [f"{mode}{i}" for i in range(len(pool))]
        ref = map_pairs if mode == "pe" else map_reads
        out[mode] = pool, names, ref(world[3], spec_of(CONFIGS[mode]), pool,
                                     names)
    return out


def port_lines(world, mode, path, pool, names) -> list[str]:
    """The port's SAM lines of the pool: its numpy oracle, its plain
    PyTorch path on the CPU, or that path with a finalize pool of two
    workers."""
    from bitmapperbs_tpu_torch.models.host import map_batch, map_batch_pe
    from bitmapperbs_tpu_torch.models.pool import make_finalize_pool
    from bitmapperbs_tpu_torch.oracle import paired, pipeline

    torch.set_num_threads(1)
    _, idx, dix, _ = world
    cfg = CONFIGS[mode]
    pe = mode == "pe"
    quals = ([("I" * len(a), "I" * len(b)) for a, b in pool] if pe
             else ["I" * len(r) for r in pool])
    if path == "oracle":
        fn = paired.map_batch_pe if pe else pipeline.map_batch_se
        return [r.line() for r in fn(idx, cfg, pool, quals, names)]
    workers = make_finalize_pool(idx, cfg, 2) if path == "pool" else None
    try:
        fn = map_batch_pe if pe else map_batch
        return [r.line() for r in fn(idx, dix, cfg, pool, quals, names,
                                     pool=workers)]
    finally:
        if workers is not None:
            workers.terminate()
            workers.join()


@pytest.mark.parametrize("path", ["oracle", "plain", "pool"])
@pytest.mark.parametrize("mode", ["pe", "pbat_se"])
def test_records_equal_the_reference(world, wanted, mode, path):
    """Every record as the reference writes it, the G->A hits with an indel
    and (PE) every mate field among them."""
    pool, names, want = wanted[mode]
    got = port_lines(world, mode, path, pool, names)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g == w
    assert sum(map(ga_gapped, want)) >= 5
    if mode == "pe":
        recs = [fields(x) for x in want]
        pairs = list(zip(recs[::2], recs[1::2]))
        unmapped_mate = sum((int(a[1]) ^ int(b[1])) & 0x4 > 0
                            for a, b in pairs)
        improper_one_contig = sum(
            not int(a[1]) & 0x6 and not int(b[1]) & 0x4 and a[2] == b[2]
            for a, b in pairs)
        assert unmapped_mate >= 3 and improper_one_contig >= 1, \
            (unmapped_mate, improper_one_contig)


def rec(rname, pos, cigar, flag):
    from bitmapperbs_tpu_torch.io.sam import SamRecord

    return SamRecord("p", flag, rname, pos, 42 if pos else 0, cigar)


MATE_CASES = {
    # name: (mate 1, mate 2) as (RNAME, POS, CIGAR, FLAG); then each mate's
    # (RNEXT, PNEXT, TLEN)
    "unmapped mate": ((("chr1", 1001, "150M", 0x49), ("*", 0, "*", 0x85)),
                      (("*", 0, 0), ("chr1", 1001, 0))),
    "not proper on one contig": (
        (("chr1", 5001, "150M", 0x61), ("chr1", 1001, "148M2D2M", 0x91)),
        (("=", 1001, -4150), ("=", 5001, 4150))),
    "left mate ends past the right": (
        (("chr1", 101, "150M", 0x63), ("chr1", 121, "100M", 0x93)),
        (("=", 121, 150), ("=", 101, -150))),
    "two contigs": ((("chr1", 101, "150M", 0x41), ("chr2", 7, "150M", 0x81)),
                    (("chr2", 7, 0), ("chr1", 101, 0))),
}


@pytest.mark.parametrize("name", MATE_CASES)
def test_mate_fields_follow_sam_v1(name):
    """oracle/paired.mate_fields, which both PE assemblers call: RNEXT,
    PNEXT and TLEN as SAM v1 (and the reference) give them, FLAG and MAPQ
    untouched."""
    from bitmapperbs_tpu_torch.oracle.paired import mate_fields

    mates, want = MATE_CASES[name]
    recs = [rec(*m) for m in mates]
    mate_fields(*recs)
    assert [(r.rnext, r.pnext, r.tlen) for r in recs] == list(want)
    assert [(r.flag, r.mapq) for r in recs] == [
        (m[3], 42 if m[1] else 0) for m in mates]
    ref = [[m[0], str(m[3]), m[0], str(m[1]), "", m[2], "*", "0", "0"]
           for m in mates]
    mend_mates(*ref)
    assert [tuple(f[6:9]) for f in ref] == [
        (a, str(b), str(c)) for a, b, c in want]


TINY_PE = """
import json, sys
from wgbs_bench import cache
from wgbs_bench.tests.helpers import make_root, tiny_run
cache.ROOT = sys.argv[1] + "/cache"
result, info = tiny_run(make_root(sys.argv[1] + "/checkout",
                                  threads=int(sys.argv[2])), "tiny-pe.wgbs")
print(json.dumps({"result": result, "check": info["check"]}))
"""


@pytest.mark.parametrize("threads", [1, 2])
def test_tiny_pe_cell_is_correct(tmp_path, threads):
    """The harness's tiny directional PE cell (the benchmark's PE
    configuration on the tiny genome) comes out correct: no sampled pair
    mismatched or missing, with and without the finalize pool.  In a
    process of its own: the harness refuses to run beside jax, which this
    test process has loaded."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", TINY_PE, str(tmp_path),
                        str(threads)], capture_output=True, text=True,
                       cwd=root, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.splitlines()[-1])
    result, chk = out["result"], out["check"]
    assert chk["compared"] > 0 and result["failed"] == 0
    assert (chk["mismatched_records"], chk["missing_records"]) == (0, 0), \
        chk["example"]
    assert result["correct"] is True


@pytest.mark.parametrize("threads", ["1", "2"])
def test_profile_counts_pairs_and_ga_records(world, wanted, tmp_path, capsys,
                                             threads):
    """A `--profile` PE run's stage line counts every pair mapped
    (pe.pairs), the proper-pair and mate-unmapped records (FLAG 0x2 and 0x8
    of the SAM written), the G->A records with an indel, and the pairs that
    rescue completed."""
    from bitmapperbs_tpu_torch.cli import main

    pool, names, want = wanted["pe"]
    fa = tmp_path / "ref.fa"
    fa.write_text(world[0].fasta())
    paths, _ = traffic.write_pool(PE, pool, str(tmp_path))
    assert main(["index", str(fa)]) == 0
    out = tmp_path / "out.sam"
    assert main(["search", str(fa), "--pe", "--seq1", paths[0], "--seq2",
                 paths[1], "--min", "0", "--max", "500", "-e", "4",
                 "--seed-ext", "20", "--max-candidates", "128",
                 "--batch-size", "32", "--platform", "cpu", "-t", threads,
                 "--profile", str(tmp_path / "prof"), "-o", str(out)]) == 0
    err = capsys.readouterr().err
    stage = next(ln for ln in err.splitlines() if "stages:" in ln)
    got = {k: int(v) for k, v in re.findall(r"([a-z_.]+)=(\d+)(?=\s|$)",
                                            stage)}
    body = [fields(ln) for ln in out.read_text().splitlines()
            if not ln.startswith("@")]
    assert len(body) == 2 * len(pool)
    assert got["pe.pairs"] == len(pool)
    assert got["pe.proper_records"] == sum(int(f[1]) & 0x2 > 0 for f in body)
    assert got["pe.mate_unmapped_records"] == sum(int(f[1]) & 0x8 > 0
                                                  for f in body)
    assert got["sam.ga_gapped_records"] == sum(
        ga_gapped("\t".join(f)) for f in body) > 0
    assert 0 < got["pe.rescue_hits"] < len(pool)
    if threads == "2":
        assert got["pool.text_records"] == len(body)


def test_native_finalize_equals_numpy_on_ga_records(world, wanted,
                                                    monkeypatch):
    """finalize.cpp against the numpy finalizer on the PBAT reads' device
    outputs, G->A hits with an indel among them.  Runs where the port's
    libsais.so is built (`make -C bitmapperbs_tpu_torch/index/sais_native`)."""
    from bitmapperbs_tpu_torch.models import native_finalize
    from bitmapperbs_tpu_torch.models.aligner import map_batch_device
    from bitmapperbs_tpu_torch.models.finalize import finalize_batch_device
    from bitmapperbs_tpu_torch.models.host import prepare_batch, to_host

    if not native_finalize.available():
        pytest.skip("the port's native library (libsais.so) is not built")
    _, idx, dix, _ = world
    pool, names, _ = wanted["pbat_se"]
    cfg = CONFIGS["pbat_se"].replace(batch_size=len(pool))
    arr, lens = prepare_batch(pool, cfg.read_len_bucket, len(pool))
    out_np = to_host(map_batch_device(dix, cfg, torch.from_numpy(arr),
                                      torch.from_numpy(lens)))
    rc_ref = idx.genome.rc_codes()
    quals = ["I" * len(r) for r in pool]
    args = (idx, rc_ref, cfg, arr, lens, quals, names, out_np)
    got = native_finalize.finalize_se_native(*args)
    want = finalize_batch_device(*args)
    assert [r and r.line() for r in got] == [r and r.line() for r in want]
    assert sum(ga_gapped(r.line()) for r in want if r) >= 3
