"""PyTorch port: records finalized in the pool cross to the main process as
SAM text (io/sam.SamText, the text in a file of the pool's directory that
the main process reads and removes) and come out as SamLines.  A spawned
pool of 2 gives the in-process run's lines record for record, SE and PE, with
unmapped, reverse-strand and gapped records among them; MapStats, SamWriter
and BamWriter fed the SamLines give the in-process records' counts and
bytes; and `search -t 2` writes the SAM and BAM bytes of `-t 1`."""
import gc
import gzip
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bitmapperbs_tpu_torch import constants as K  # noqa: E402
from bitmapperbs_tpu_torch.cli import main  # noqa: E402
from bitmapperbs_tpu_torch.config import AlignerConfig  # noqa: E402
from bitmapperbs_tpu_torch.index.build import build_index  # noqa: E402
from bitmapperbs_tpu_torch.index.device import upload_index  # noqa: E402
from bitmapperbs_tpu_torch.io.bam import BamWriter  # noqa: E402
from bitmapperbs_tpu_torch.io.fastq import write_fastq  # noqa: E402
from bitmapperbs_tpu_torch.io.sam import (SamLine, SamRecord,  # noqa: E402
                                          SamText, SamWriter)
from bitmapperbs_tpu_torch.io.stats import MapStats  # noqa: E402
from bitmapperbs_tpu_torch.models import host  # noqa: E402
from bitmapperbs_tpu_torch.models.pool import make_finalize_pool  # noqa: E402
from bitmapperbs_tpu_torch.utils.simulate import (  # noqa: E402
    random_genome_fasta, simulate_pairs, simulate_reads)

BS = 16
N_FOREIGN = 6      # reads (pairs) drawn at random: unmapped


def cfg(pe: bool) -> AlignerConfig:
    return AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                         batch_size=BS, paired=pe, min_insert=100,
                         max_insert=400)


@pytest.fixture(scope="module")
def world():
    """A small index on the CPU; 42 reads and 22 pairs with indels, quals
    and names, the last N_FOREIGN of each random; one spawned pool of 2
    (a task carries its own config, so it serves SE and PE)."""
    rng = np.random.default_rng(31)
    fa = random_genome_fasta(rng, contigs=(6000, 3000))
    idx = build_index(fa)
    se = simulate_reads(idx.genome, 42 - N_FOREIGN, read_len=80, seed=7,
                        sub_rate=0.01, indel_rate=0.01)
    pe = simulate_pairs(idx.genome, 22 - N_FOREIGN, read_len=80, seed=8,
                        min_insert=150, max_insert=300, sub_rate=0.01,
                        indel_rate=0.01)

    def foreign():
        return rng.integers(0, 4, size=80).astype(np.uint8)

    reads = [s.codes for s in se] + [foreign() for _ in range(N_FOREIGN)]
    quals = [s.qual for s in se] + ["I" * 80] * N_FOREIGN
    pairs = [(a.codes, b.codes) for a, b in pe] + [
        (foreign(), foreign()) for _ in range(N_FOREIGN)]
    pquals = [(a.qual, b.qual) for a, b in pe] + [("I" * 80,) * 2] * N_FOREIGN
    pool = make_finalize_pool(idx, cfg(False), 2)
    try:
        yield {"idx": idx, "dix": upload_index(idx), "pool": pool,
               "se": (reads, quals, [f"r{i}" for i in range(len(reads))]),
               "pe": (pairs, pquals, [f"p{i}" for i in range(len(pairs))])}
    finally:
        pool.terminate()
        pool.join()


def run(world, pe: bool, pool=None):
    fn = host.map_batch_pe if pe else host.map_batch
    return fn(world["idx"], world["dix"], cfg(pe),
              *world["pe" if pe else "se"], pool=pool)


def write_all(writer, recs):
    """Each item through the writer and MapStats, as the benchmark's loop
    and the CLI write them."""
    stats = MapStats()
    for r in recs:
        writer.write(r)
        stats.add_record(r)
    return stats.to_json()


@pytest.mark.parametrize("pe", [False, True])
def test_pooled_lines_equal_the_in_process_records(world, pe):
    """SamLines from the pool: the in-process records' lines, flags, MAPQs
    and NMs; the same MapStats and SAM bytes."""
    want = run(world, pe)
    got = run(world, pe, world["pool"])
    n = len(world["pe" if pe else "se"][0]) * (2 if pe else 1)
    assert len(got) == len(want) == n
    assert all(type(r) is SamRecord for r in want)
    assert all(type(r) is SamLine for r in got)
    assert [r.line() for r in got] == [r.line() for r in want]
    assert [(r.flag, r.mapq, r.nm) for r in got] \
        == [(r.flag, r.mapq, r.nm) for r in want]
    flags = [r.flag for r in want]
    assert sum(f & K.FLAG_UNMAPPED != 0 for f in flags) >= N_FOREIGN
    assert any(f & 0x10 for f in flags)
    assert any(set(r.cigar) & set("ID") for r in want)
    assert any(r.nm is None for r in want) and any(r.nm for r in want)
    outs = []
    for recs in (want, got):
        fh = io.StringIO()
        w = SamWriter(fh, world["idx"].genome.names,
                      world["idx"].genome.lengths, cl="t")
        outs.append((fh, write_all(w, recs)))
    assert outs[0][1] == outs[1][1]
    assert outs[0][0].getvalue() == outs[1][0].getvalue()
    # every task's text file was read back and removed
    pool_dir = world["pool"].apply(eval, (
        "__import__('bitmapperbs_tpu_torch.models.pool', fromlist=['_'])"
        "._POOL_CTX['dir']",))
    assert sorted(os.listdir(pool_dir)) == ["codes.u8", "rc.u8"]


@pytest.mark.parametrize("pe", [False, True])
def test_bam_of_pooled_lines_equals_bam_of_records(world, pe):
    """BamWriter parses a SamLine back (SamRecord.from_line): the BAM of the
    pooled run is the in-process run's, byte for byte."""
    outs = []
    for pool in (None, world["pool"]):
        fh = io.BytesIO()
        w = BamWriter(fh, world["idx"].genome.names,
                      world["idx"].genome.lengths, rg="lib1", cl="t")
        write_all(w, run(world, pe, pool))
        w.close()
        outs.append(fh.getvalue())
    assert outs[0] == outs[1] and len(outs[0]) > 1000


def test_sam_text_round_trip_and_checks():
    """pack / lines keep order and None NMs; an empty batch is empty; the
    collector's state is left as it was; a line holding a newline is
    refused, not split into two records."""
    recs = [SamRecord("a", 4, seq="ACG", qual="!!!"),
            SamRecord("b", 16, "chr1", 5, 40, "3M", nm=0, md="3", xm="...",
                      xr="CT", xg="GA"),
            SamRecord("c", 0, "chr2", 9, 0, "1M1I1M", nm=2, md="2")]
    lines = SamText.pack(recs).lines()
    assert [(s.text, s.flag, s.mapq, s.nm) for s in lines] == [
        (r.line(), r.flag, r.mapq, r.nm) for r in recs]
    assert [SamRecord.from_line(s.text) for s in lines] == recs
    assert SamText.pack([]).lines() == []
    assert gc.isenabled()       # the collector's pause is undone
    gc.disable()
    try:
        assert len(SamText.pack(recs).lines()) == 3 and not gc.isenabled()
    finally:
        gc.enable()
    bad = SamText.pack([SamRecord("x\ny", 4)])
    with pytest.raises(ValueError, match="2 SAM lines for 1 records"):
        bad.lines()
    with pytest.raises(ValueError, match="unknown SAM tag"):
        SamRecord.from_line(recs[0].line() + "\tXX:i:1")


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory, world):
    """The world's reads and pairs as FASTQ beside an indexed reference."""
    d = tmp_path_factory.mktemp("pool_text_cli")
    fa = random_genome_fasta(np.random.default_rng(31), contigs=(6000, 3000))
    (d / "ref.fa").write_text(fa)
    reads, quals, names = world["se"]
    write_fastq(d / "r.fq", reads, qnames=names, quals=quals)
    pairs, pquals, pnames = world["pe"]
    for m in (0, 1):
        write_fastq(d / f"p{m + 1}.fq", [p[m] for p in pairs], qnames=pnames,
                    quals=[q[m] for q in pquals])
    assert main(["index", str(d / "ref.fa")]) == 0
    return d


@pytest.mark.parametrize("pe", [False, True])
@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_cli_pool_writes_the_in_process_bytes(cli_dir, pe, fmt):
    """`search -t 2` writes the bytes and stats of `-t 1`.  For BAM the
    bytes inside BGZF: the CLI closes a BGZF block at each checkpoint, and
    SE checkpoints once per `-t` reader batches."""
    d = cli_dir
    seqs = (["--pe", "--seq1", str(d / "p1.fq"), "--seq2", str(d / "p2.fq")]
            if pe else ["--seq", str(d / "r.fq")])
    out = []
    for t in ("1", "2"):
        o = d / f"{'pe' if pe else 'se'}_t{t}.{fmt}"
        js = d / f"{'pe' if pe else 'se'}_t{t}_{fmt}.json"
        argv = ["search", str(d / "ref.fa"), *seqs, "--platform", "cpu",
                "--batch-size", str(BS), "-t", t, "-o", str(o),
                "--stats-json", str(js)]
        if fmt == "bam":
            argv.append("--bam")
        assert main(argv) == 0
        data = o.read_bytes()
        out.append((gzip.decompress(data) if fmt == "bam" else data,
                    js.read_text()))
    assert out[0] == out[1]
    assert len(out[0][0]) > 1000
