"""PyTorch port, the one mapping loop (models/host.map_reader_batches):
fed the reader's batches, with a record-strided shard filter that empties
one batch, it yields the records, their order and the cursors that
cmd_search writes for the same input and options, single-end with the
device mappers and a call of two batches, paired-end, and `--oracle`.  All
on the CPU (`--platform cpu`)."""
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bitmapperbs_tpu_torch import cli  # noqa: E402
from bitmapperbs_tpu_torch.index.build import load_index, parse_fasta  # noqa: E402
from bitmapperbs_tpu_torch.index.device import upload_index  # noqa: E402
from bitmapperbs_tpu_torch.io.fastq import (FastqReader, read_pairs,  # noqa: E402
                                            write_fastq)
from bitmapperbs_tpu_torch.models import host  # noqa: E402
from bitmapperbs_tpu_torch.oracle.pipeline import map_batch_se  # noqa: E402
from bitmapperbs_tpu_torch.parallel import multihost  # noqa: E402
from bitmapperbs_tpu_torch.utils.simulate import (  # noqa: E402
    random_genome_fasta, simulate_pairs, simulate_reads)

N, BATCH, HOSTS = 24, 4, 5      # six reader batches; host h owns r % 5 == h


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_host_loop")
    fa = random_genome_fasta(np.random.default_rng(31), contigs=(3000, 1500))
    (d / "ref.fa").write_text(fa)
    g = parse_fasta(fa)
    sims = simulate_reads(g, N, read_len=64, seed=3, sub_rate=0.01,
                          indel_rate=0.005)
    write_fastq(d / "reads.fq", [s.codes for s in sims],
                [f"r{i}" for i in range(N)], [s.qual for s in sims])
    prs = simulate_pairs(g, N, read_len=60, seed=4, sub_rate=0.01,
                         min_insert=120, max_insert=300)
    for mate in (0, 1):
        write_fastq(d / f"r{mate + 1}.fq", [p[mate].codes for p in prs],
                    [f"p{i}" for i in range(N)], [p[mate].qual for p in prs])
    assert cli.main(["index", str(d / "ref.fa")]) == 0
    return d


def record_ends(path) -> list[int]:
    """Byte offset after each FASTQ record (four lines)."""
    data = open(path, "rb").read()
    nl = [i + 1 for i, c in enumerate(data) if c == ord("\n")]
    return nl[3::4]


# mode: options, shard host, threads, the cursors' records and the calls
# of no records.  Host 1's shard empties batch 3 while batch 2 waits in a
# call of two, which acknowledges both; host 0's empties batch 4 with
# nothing waiting; a PE call takes one batch, so its empty batch is
# acknowledged at once.
CASES = {
    "se": ([], 1, 2, [8, 20, 24], 0),
    "pe": (["--pe", "--min", "100", "--max", "350"], 1, 1,
           [4, 8, 12, 16, 20, 24], 1),
    "oracle": (["--oracle"], 0, 2, [8, 16, 20, 24], 1),
}


@pytest.mark.parametrize("mode", list(CASES))
def test_loop_equals_cmd_search(data, monkeypatch, mode):
    extra, hid, threads, want_records, acks = CASES[mode]
    d, pe = data, mode == "pe"
    inputs = ([str(d / "r1.fq"), str(d / "r2.fq")] if pe
              else [str(d / "reads.fq")])
    argv = (["search", str(d / "ref.fa"), "--platform", "cpu",
             "--batch-size", str(BATCH), "--read-bucket", "64", "-t",
             str(threads), "--dist-hosts", str(HOSTS), "--dist-host-id",
             str(hid), "--dist-shard", "records"] + extra
            + (["--seq1", inputs[0], "--seq2", inputs[1]] if pe
               else ["--seq", inputs[0]]))

    # cmd_search's output and every cursor it writes
    monkeypatch.setattr(multihost, "init_distributed",
                        lambda c, n, p: (p or 0, n))
    seen, replace = [], os.replace

    def spy(src, dst):
        if str(dst).endswith(".cursor"):
            with open(src) as f:
                seen.append(json.load(f))
        replace(src, dst)
    monkeypatch.setattr(os, "replace", spy)
    out = d / f"{mode}.sam"
    assert cli.main(argv + ["-o", str(out)]) == 0
    monkeypatch.setattr(os, "replace", replace)
    want = [ln for ln in open(multihost.shard_path(str(out), hid, HOSTS))
            .read().splitlines() if ln and not ln.startswith("@")]

    # the loop itself, with the configuration cmd_search makes
    args = cli.build_parser().parse_args(argv)
    idx = load_index(cli.default_prefix(str(d / "ref.fa")))
    cfg = cli.autotune_for_genome(cli.make_config(args), args,
                                  int(sum(idx.genome.lengths)))
    if mode == "oracle":
        def run(c, units, quals, qnames):
            return map_batch_se(idx, c, units, quals, qnames)
    else:
        dix = upload_index(idx, torch.device("cpu"))
        mapper = host.map_batch_pe if pe else host.map_batch

        def run(c, units, quals, qnames):
            return mapper(idx, dix, c, units, quals, qnames)
    batches = (read_pairs(*inputs, BATCH) if pe
               else FastqReader(inputs[0], BATCH))
    calls = list(host.map_reader_batches(
        cfg, batches, run, functools.partial(cli._cfg_key, cfg, None),
        per_call=1 if pe else threads,
        keep=multihost.HostShard(hid, HOSTS).filter_batch))

    recs = [r for c in calls for r in c[0]]
    assert [r.line() for r in recs] == want
    owned = [i for i in range(N) if i % HOSTS == hid]
    names = [q for c in calls for q in c[2]]
    assert names == [r.qname for r in recs] == [
        f"{'p' if pe else 'r'}{i}" for i in owned for _ in range(1 + pe)]
    assert all(len(c[1]) == len(c[2]) == len(c[3]) == len(c[0])
               for c in calls)
    assert sum(not c[0] for c in calls) == acks
    ends = [record_ends(p) for p in inputs]
    cursors = [c[4] for c in calls]
    assert cursors == [(r, *(e[r - 1] for e in ends))
                       for r in want_records]
    assert [(c["record"], c["offset"], *((c["offset2"],) if pe else ()))
            for c in seen] == cursors
