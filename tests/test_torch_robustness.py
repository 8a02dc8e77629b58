"""PyTorch port, edge inputs held to the reference package (records equal,
tolerance 0): read buckets 32 / 64 / 160, reads with planted Ns, all-N,
poly-A / poly-T, 3-base and 1-base reads (directional, PBAT, mismatch-only);
pairs with an all-N, a 3-base or a 40-base mate and with both mates all-N;
and command-line cases: mixed read lengths under an error rate, a grown
read bucket, gzipped input with the side files, an empty FASTQ, BAM to
stdout and a missing index.  The reference's records are taken to their
SAM v1 form first (tests/sam_v1.py)."""
import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bitmapperbs_tpu import constants as K  # noqa: E402
from bitmapperbs_tpu.cli import main as jmain  # noqa: E402
from bitmapperbs_tpu.config import AlignerConfig  # noqa: E402
from bitmapperbs_tpu.index.build import build_index  # noqa: E402
from bitmapperbs_tpu.io.fastq import write_fastq  # noqa: E402
from bitmapperbs_tpu.oracle.paired import map_batch_pe as oracle_pe  # noqa: E402
from bitmapperbs_tpu.oracle.pipeline import map_batch_se as oracle_se  # noqa: E402
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,  # noqa: E402
                                            simulate_pairs, simulate_reads)
from bitmapperbs_tpu_torch.cli import main  # noqa: E402
from bitmapperbs_tpu_torch.config import AlignerConfig as TConfig  # noqa: E402
from bitmapperbs_tpu_torch.index.device import upload_index  # noqa: E402
from bitmapperbs_tpu_torch.models.host import map_batch, map_batch_pe  # noqa: E402
from sam_v1 import sam_v1  # noqa: E402


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_robust")
    fa = random_genome_fasta(np.random.default_rng(29), contigs=(8000, 3000))
    (d / "ref.fa").write_text(fa)
    assert main(["index", str(d / "ref.fa")]) == 0
    idx = build_index(fa)
    return d, idx, upload_index(idx)


def port_cfg(cfg):
    return TConfig.from_reference(cfg)


def edge_reads(idx, n, read_len, seed):
    """Simulated reads, three of them with planted Ns, then an all-N read,
    poly-A and poly-T reads, a 3-base and a 1-base read."""
    rng = np.random.default_rng(seed)
    reads = [s.codes for s in simulate_reads(idx.genome, n,
                                             read_len=read_len, seed=seed,
                                             sub_rate=0.01)]
    for r in reads[:3]:
        r[rng.integers(0, len(r), 3)] = K.N_CODE
    return reads + [np.full(read_len, K.N_CODE, np.uint8),
                    np.full(read_len, K.A, np.uint8),
                    np.full(read_len, K.T, np.uint8),
                    np.array([K.A, K.C, K.G], np.uint8),
                    np.array([K.G], np.uint8)]


SE_CASES = {
    # name: (read length, bucket, max_errors, indels, PBAT)
    "bucket 32, e 1": (30, 32, 1, True, False),
    "bucket 64, mismatch-only": (64, 64, 2, False, False),
    "bucket 160, e 5": (151, 160, 5, True, False),
    "bucket 96, directional": (80, 96, 3, True, False),
    "bucket 96, PBAT": (80, 96, 3, True, True),
    "bucket 96, mismatch-only": (80, 96, 3, False, False),
}


@pytest.mark.parametrize("name", SE_CASES)
def test_se_edge_reads_match_the_reference(setup, name):
    _, idx, dix = setup
    read_len, bucket, e, indels, pbat = SE_CASES[name]
    reads = edge_reads(idx, 16, read_len, seed=50 + bucket + e)
    cfg = AlignerConfig(max_errors=e, indels=indels, non_directional=pbat,
                        read_len_bucket=bucket, batch_size=len(reads))
    got = [r.line() for r in map_batch(idx, dix, port_cfg(cfg), reads)]
    want, changed = sam_v1([r.line() for r in oracle_se(idx, cfg, reads)],
                           idx.genome, paired=False)
    assert got == want
    assert changed == 0
    assert sum("\t4\t*\t" not in ln for ln in got) >= 10   # most map


PE_CASES = {"directional": dict(), "PBAT": dict(non_directional=True),
            "mismatch-only": dict(indels=False, max_errors=2)}


@pytest.mark.parametrize("name", PE_CASES)
def test_pe_edge_mates_match_the_reference(setup, name):
    """An all-N mate, a 3-base mate, a 40-base mate and both mates all-N
    beside ordinary pairs."""
    _, idx, dix = setup
    prs = [(a.codes, b.codes) for a, b in simulate_pairs(
        idx.genome, 10, read_len=80, seed=61, min_insert=150,
        max_insert=300, sub_rate=0.01)]
    n80 = np.full(80, K.N_CODE, np.uint8)
    prs[1] = (prs[1][0], n80)
    prs[2] = (np.array([K.A, K.C, K.T], np.uint8), prs[2][1])
    prs[3] = (prs[3][0], prs[3][1][:40])
    prs[4] = (n80, n80.copy())
    cfg = AlignerConfig(**{**dict(max_errors=4, indels=True, paired=True,
                                  min_insert=100, max_insert=400,
                                  read_len_bucket=96, batch_size=len(prs)),
                           **PE_CASES[name]})
    got = [r.line() for r in map_batch_pe(idx, dix, port_cfg(cfg), prs)]
    want, changed = sam_v1([r.line() for r in oracle_pe(idx, cfg, prs)],
                           idx.genome, paired=True)
    assert got == want
    assert changed > 0              # the all-N and 3-base mates' fields
    assert len(got) == 2 * len(prs)
    assert sum(int(ln.split("\t")[1]) & 0x2 > 0 for ln in got) >= 6


def body(path, gz=False):
    text = (gzip.open(path, "rt") if gz else open(path)).read()
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


@pytest.fixture(scope="module")
def mixed(setup):
    """A FASTQ of 60, 120 and 150 bp reads, interleaved."""
    d, idx, _ = setup
    reads, quals = [], []
    for k, n in enumerate((60, 120, 150)):
        for s in simulate_reads(idx.genome, 8, read_len=n, seed=70 + k,
                                sub_rate=0.01, indel_rate=0.005):
            reads.append(s.codes)
            quals.append(s.qual)
    order = np.random.default_rng(3).permutation(len(reads))
    write_fastq(d / "mixed.fq", [reads[i] for i in order],
                [f"m{i}" for i in range(len(reads))],
                [quals[i] for i in order])
    return d / "mixed.fq"


@pytest.mark.parametrize("bucket", [None, "64"])
def test_cli_error_rate_on_mixed_lengths(setup, mixed, capsys, bucket):
    """`-e 0.035` resolves a budget per read (2 / 4 / 5 at 60 / 120 / 150
    bp) and prints the reference's note; with --read-bucket 64 the longer
    reads map in grown buckets.  Records equal the reference CLI's."""
    d = setup[0]
    common = ["search", str(d / "ref.fa"), "--seq", str(mixed), "-e",
              "0.035", "--batch-size", "8"]
    if bucket:
        common += ["--read-bucket", bucket]
    tag = bucket or "auto"
    assert main([*common, "--platform", "cpu", "-o",
                 str(d / f"mx_{tag}.sam")]) == 0
    err = capsys.readouterr().err
    assert jmain([*common, "--oracle", "-o", str(d / f"jmx_{tag}.sam")]) == 0
    jerr = capsys.readouterr().err
    note = [ln for ln in err.splitlines() if "-e 0.035 ->" in ln]
    jnote = [ln for ln in jerr.splitlines() if "-e 0.035 ->" in ln]
    assert note == [ln.replace("[bitmapperbs_tpu]", "[bitmapperbs_tpu_torch]")
                    for ln in jnote]
    assert len(note) == 1
    got = body(d / f"mx_{tag}.sam")
    assert got == body(d / f"jmx_{tag}.sam")
    assert sum(not ln.startswith("@") for ln in got) == 24


def test_cli_gz_input_and_side_files(setup, mixed):
    """Gzipped FASTQ in; --ambiguous-out, --unmapped-out and --stats-json
    beside the SAM: all four files equal the reference CLI's."""
    d, idx, _ = setup
    sims = simulate_reads(idx.genome, 24, read_len=80, seed=81,
                          sub_rate=0.01)
    reads = [s.codes for s in sims] + [np.full(80, K.A, np.uint8),
                                       np.full(80, K.N_CODE, np.uint8)]
    write_fastq(d / "g.fq", reads, [f"g{i}" for i in range(len(reads))])
    (d / "g.fq.gz").write_bytes(gzip.compress((d / "g.fq").read_bytes()))
    outs = {}
    for tag, run, extra in (("port", main, ["--platform", "cpu"]),
                            ("ref", jmain, ["--single-device"])):
        files = [d / f"{tag}_{k}" for k in ("out.sam", "amb.fq", "un.fq",
                                            "stats.json")]
        assert run(["search", str(d / "ref.fa"), "--seq", str(d / "g.fq.gz"),
                    "--batch-size", "16", "-o", str(files[0]),
                    "--ambiguous-out", str(files[1]), "--unmapped-out",
                    str(files[2]), "--stats-json", str(files[3]),
                    *extra]) == 0
        # a side file is written only when it has a read
        outs[tag] = [body(files[0])] + [f.read_text() if f.exists() else None
                                        for f in files[1:]]
    assert outs["port"] == outs["ref"]
    assert outs["port"][2].count("\n") >= 4          # an unmapped read


def errors(capsys):
    """The error lines of what the command wrote to stderr."""
    return [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("error:")]


def test_cli_empty_fastq(setup, capsys):
    """An empty FASTQ maps to a header only (rc 0), as the reference's;
    with an error rate there is no first read to size it from (rc 2)."""
    d = setup[0]
    (d / "empty.fq").write_text("")
    common = ["search", str(d / "ref.fa"), "--seq", str(d / "empty.fq")]
    assert main([*common, "--platform", "cpu", "-o", str(d / "e.sam")]) == 0
    assert jmain([*common, "--oracle", "-o", str(d / "je.sam")]) == 0
    assert body(d / "e.sam") == body(d / "je.sam")
    assert not any(not ln.startswith("@") for ln in body(d / "e.sam"))
    capsys.readouterr()
    assert main([*common, "--platform", "cpu", "-e", "0.04", "-o",
                 str(d / "e2.sam")]) == 2
    err = errors(capsys)
    assert jmain([*common, "--oracle", "-e", "0.04", "-o",
                  str(d / "je2.sam")]) == 2
    assert err == errors(capsys) == ["error: empty FASTQ"]


def test_cli_refusals(setup, capsys):
    """--bam needs -o FILE; a missing index is named (rc 2 both)."""
    d = setup[0]
    write_fastq(d / "one.fq", [np.full(40, K.A, np.uint8)])
    common = ["search", str(d / "ref.fa"), "--seq", str(d / "one.fq")]
    assert main([*common, "--platform", "cpu", "--bam"]) == 2
    err = errors(capsys)
    assert jmain([*common, "--oracle", "--bam"]) == 2
    assert err == errors(capsys) == ["error: --bam requires -o FILE"]
    missing = ["search", str(d / "nope.fa"), "--seq", str(d / "one.fq")]
    assert main([*missing, "--platform", "cpu"]) == 2
    err = capsys.readouterr().err
    assert jmain([*missing, "--oracle"]) == 2
    jerr = capsys.readouterr().err
    assert "error: index not found at" in err and \
        f"{d / 'nope.fa'}.btidx.json" in err
    assert err.split(" (run:")[0] == jerr.split(" (run:")[0]
    assert not os.path.exists(d / "nope.fa.btidx.json")
