"""PyTorch port: its own copies of the numpy-only modules (index build and
artifact format, resample, FASTQ, SAM / BAM, stats, finalize, oracle, CLI
config tuning, simulator) give the reference package's bytes and records on
the same seeded inputs.  Exact equality throughout (integers and bytes;
tolerance 0), after the reference's records are taken to their SAM v1
form (tests/sam_v1.py: the G->A gapped records and PE mate fields, which
the port writes as SAM v1 does and the reference otherwise)."""
import dataclasses
import importlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sam_v1 import jax_record, sam_v1, sam_v1_records  # noqa: E402

REF, PORT = "bitmapperbs_tpu", "bitmapperbs_tpu_torch"


def both(module: str):
    """(reference module, the port's copy)."""
    return (importlib.import_module(f"{REF}.{module}"),
            importlib.import_module(f"{PORT}.{module}"))


def artifact_bytes(prefix):
    return {ext: open(f"{prefix}.{ext}", "rb").read()
            for ext in ("bin", "json")}


@pytest.fixture(scope="module")
def fasta():
    jsim, tsim = both("utils.simulate")
    fa = jsim.repeat_genome_fasta(np.random.default_rng(17),
                                  contigs=(9000, 4000))
    assert fa == tsim.repeat_genome_fasta(np.random.default_rng(17),
                                          contigs=(9000, 4000))
    return fa


@pytest.fixture(scope="module")
def indexes(fasta):
    jb, tb = both("index.build")
    return jb.build_index(fasta), tb.build_index(fasta)


@pytest.fixture(scope="module")
def reads(indexes):
    """Seeded SE reads and pairs, from both simulators (held equal)."""
    jsim, tsim = both("utils.simulate")
    out = []
    for sim, idx in zip((jsim, tsim), indexes):
        se = sim.simulate_reads(idx.genome, 40, read_len=80, seed=5,
                                sub_rate=0.01, indel_rate=0.005)
        pe = sim.simulate_pairs(idx.genome, 16, read_len=80, seed=6,
                                min_insert=150, max_insert=300,
                                sub_rate=0.01, indel_rate=0.005)
        out.append((se, pe))
    (jse, jpe), (tse, tpe) = out
    for a, b in zip(jse + [m for p in jpe for m in p],
                    tse + [m for p in tpe for m in p]):
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        for k, v in dataclasses.asdict(a).items():
            np.testing.assert_array_equal(v, dataclasses.asdict(b)[k], k)
    return tse, tpe


# ---- index artifact ----------------------------------------------------------

def test_index_build_artifact_bytes(indexes, tmp_path):
    jb, tb = both("index.build")
    jidx, tidx = indexes
    jb.save_index(jidx, str(tmp_path / "ref"))
    tb.save_index(tidx, str(tmp_path / "port"))
    want = artifact_bytes(tmp_path / "ref")
    assert artifact_bytes(tmp_path / "port") == want
    assert len(want["bin"]) > 100_000


@pytest.mark.parametrize("writer", [REF, PORT])
def test_index_artifact_loads_in_the_other_package(indexes, tmp_path, writer):
    """An artifact written by either package loads in the other (mmap and
    copy) and saves again to the same bytes."""
    jb, tb = both("index.build")
    save, idx, load, resave = (
        (jb.save_index, indexes[0], tb.load_index, tb.save_index)
        if writer == REF else
        (tb.save_index, indexes[1], jb.load_index, jb.save_index))
    save(idx, str(tmp_path / "a"))
    for mmap in (True, False):
        back = load(str(tmp_path / "a"), mmap=mmap)
        assert back.genome.names == idx.genome.names
        for b0, b1 in zip(idx.blocks, back.blocks):
            assert (b0.n, b0.sa_rate, b0.klt_k) == (b1.n, b1.sa_rate,
                                                    b1.klt_k)
            for f in ("cbase", "cp_rows", "sa_samples", "klt"):
                np.testing.assert_array_equal(getattr(b0, f), getattr(b1, f))
        resave(back, str(tmp_path / "b"))
        assert artifact_bytes(tmp_path / "b") == artifact_bytes(tmp_path / "a")


def test_resample_artifact_bytes(fasta, tmp_path):
    jb, tb = both("index.build")
    jr, tr = both("index.resample")
    out = []
    for b, r, name in ((jb, jr, "ref"), (tb, tr, "port")):
        idx = b.build_index(fasta, sa_rate=8)
        r.halve_sa_rate(idx, 2)
        b.save_index(idx, str(tmp_path / name))
        out.append(artifact_bytes(tmp_path / name))
    assert out[0] == out[1]
    direct = tb.build_index(fasta, sa_rate=2)
    tb.save_index(direct, str(tmp_path / "direct"))
    assert artifact_bytes(tmp_path / "direct")["bin"] == out[1]["bin"]


def test_genome_plane_cache_bytes(indexes, tmp_path):
    """The derived gplanes_<sha>.v1.bin cache: same path and bytes from the
    reference's device upload and from the port's."""
    from bitmapperbs_tpu.index import device as jdev
    from bitmapperbs_tpu_torch.index import device as tdev

    jb, tb = both("index.build")
    for name, b, idx in (("j", jb, indexes[0]), ("t", tb, indexes[1])):
        (tmp_path / name).mkdir()
        b.save_index(idx, str(tmp_path / name / "ref"))
    jidx = jb.load_index(str(tmp_path / "j" / "ref"))
    tidx = tb.load_index(str(tmp_path / "t" / "ref"))
    jdev.upload_index(jidx)
    tdev.upload_index(tidx)
    jc = sorted(p.name for p in (tmp_path / "j").glob("gplanes_*"))
    tc = sorted(p.name for p in (tmp_path / "t").glob("gplanes_*"))
    assert jc == tc and len(jc) == 1
    assert (tmp_path / "j" / jc[0]).read_bytes() == \
        (tmp_path / "t" / tc[0]).read_bytes()
    # a cache written by the reference is what the port then uploads
    td = tdev.upload_index(tb.load_index(str(tmp_path / "j" / "ref")))
    np.testing.assert_array_equal(
        td.g_planes.numpy().view(np.uint32),
        np.asarray(jdev.upload_index(jidx).g_planes))


# ---- io ------------------------------------------------------------------------

def test_fastq_parse(reads, tmp_path):
    jfq, tfq = both("io.fastq")
    se, pe = reads
    codes = [s.codes for s in se]
    codes[3] = np.array([0, 4, 1, 4, 2, 3] * 9, dtype=np.uint8)   # with N
    quals = [s.qual for s in se]
    quals[3] = "#" * 54
    jfq.write_fastq(tmp_path / "j.fq", codes, quals=quals)
    tfq.write_fastq(tmp_path / "t.fq", codes, quals=quals)
    assert (tmp_path / "j.fq").read_bytes() == (tmp_path / "t.fq").read_bytes()
    for mate in (0, 1):
        tfq.write_fastq(tmp_path / f"p{mate}.fq", [p[mate].codes for p in pe],
                        qnames=[f"q{i}" for i in range(len(pe))],
                        quals=[p[mate].qual for p in pe])

    def flat(batches):
        out = []
        for b in batches:
            bs = b if isinstance(b, tuple) else (b,)
            for x in bs:
                out.append(([c.tobytes() for c in x.codes], list(x.qnames),
                            list(x.quals)))
        return out

    want = flat(jfq.FastqReader(str(tmp_path / "j.fq"), batch_size=16))
    got = flat(tfq.FastqReader(str(tmp_path / "j.fq"), batch_size=16))
    assert got == want and sum(len(b[0]) for b in got) == 40
    assert flat(tfq.Prefetcher(tfq.read_pairs(
        str(tmp_path / "p0.fq"), str(tmp_path / "p1.fq"), 8))) == flat(
        jfq.Prefetcher(jfq.read_pairs(
            str(tmp_path / "p0.fq"), str(tmp_path / "p1.fq"), 8)))


@pytest.fixture(scope="module")
def oracle_records(indexes, reads):
    """The oracle's SE and PE records from both packages (held equal in
    test_oracle_records); the port's are what the writers below get."""
    jc, tc = both("config")
    jo, to = both("oracle.pipeline")
    jp, tp = both("oracle.paired")
    se, pe = reads
    codes, quals = [s.codes for s in se], [s.qual for s in se]
    pairs = [(a.codes, b.codes) for a, b in pe]
    pquals = [(a.qual, b.qual) for a, b in pe]
    out = []
    for cfg_mod, o, p, idx in ((jc, jo, jp, indexes[0]),
                               (tc, to, tp, indexes[1])):
        cfg = cfg_mod.AlignerConfig(max_errors=4, read_len_bucket=96)
        pcfg = cfg.replace(paired=True, min_insert=100, max_insert=400)
        out.append((o.map_batch_se(idx, cfg, codes, quals),
                    p.map_batch_pe(idx, pcfg, pairs, pquals)))
    return out


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_oracle_records(indexes, oracle_records, kind):
    k = 0 if kind == "se" else 1
    want, changed = sam_v1([r.line() for r in oracle_records[0][k]],
                           indexes[0].genome, paired=kind == "pe")
    got = [r.line() for r in oracle_records[1][k]]
    assert got == want
    assert (changed > 0) == (kind == "pe")  # directional SE: none
    assert len(got) == (40 if kind == "se" else 32)
    assert sum("\t4\t" not in ln[:40] for ln in got) > len(got) // 2


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_from_line_inverts_line(oracle_records, kind):
    """SamRecord.from_line (how BamWriter reads a pooled SamLine) gives each
    oracle record back from its line, and each with its qual as `*`: tags
    left out among them, and NM None in the SE records (unmapped reads)."""
    from bitmapperbs_tpu_torch.io.sam import SamRecord

    recs = oracle_records[1][0 if kind == "se" else 1]
    recs = recs + [dataclasses.replace(r, qual="*") for r in recs]
    assert [SamRecord.from_line(r.line()) for r in recs] == recs
    assert any(r.xg for r in recs)
    assert any(r.nm is None for r in recs) == (kind == "se")


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_sam_and_bam_bytes(indexes, oracle_records, fmt):
    jmod, tmod = both("io." + fmt)
    jstats, tstats = both("io.stats")
    jsam, tsam = both("io.sam")
    from_line = jax_record(tsam.SamRecord, jsam.SamRecord)
    (jse, _), (jpe, changed) = (
        sam_v1_records(recs, indexes[0].genome, paired, from_line)
        for recs, paired in zip(oracle_records[0], (False, True)))
    assert changed > 0
    out = []
    for mod, stats_mod, idx, recs in (
            (jmod, jstats, indexes[0], (jse, jpe)),
            (tmod, tstats, indexes[1], oracle_records[1])):
        fh = io.BytesIO() if fmt == "bam" else io.StringIO()
        cls = mod.BamWriter if fmt == "bam" else mod.SamWriter
        w = cls(fh, idx.genome.names, idx.genome.lengths, rg="lib1",
                cl="prog search ref.fa")
        st = stats_mod.MapStats()
        for r in recs[0] + recs[1]:
            w.write(r)
            st.add_record(r)
        if fmt == "bam":
            w.close()
        out.append((fh.getvalue(), st.to_json()))
    assert out[0] == out[1]
    assert len(out[0][0]) > 2000


# ---- finalize (numpy path) -------------------------------------------------------

def test_finalize_records(indexes, reads, monkeypatch):
    """models/pool finalize of one device output dict: the port's copy and
    the reference's give the same records (native library off: the numpy
    spec path)."""
    from bitmapperbs_tpu_torch.index.device import upload_index
    from bitmapperbs_tpu_torch.models.aligner import map_batch_device
    from bitmapperbs_tpu_torch.models.host import prepare_batch, to_host

    monkeypatch.setenv("BTBS_NO_NATIVE_FINALIZE", "1")
    jc, tc = both("config")
    jpool, tpool = both("models.pool")
    se, _ = reads
    codes, quals = [s.codes for s in se], [s.qual for s in se]
    qnames = [f"r{i}" for i in range(len(codes))]
    cfg = tc.AlignerConfig(max_errors=4, read_len_bucket=96, batch_size=64)
    arr, lens = prepare_batch(codes, 96, 64)
    out_np = to_host(map_batch_device(upload_index(indexes[1]), cfg,
                                      torch.from_numpy(arr),
                                      torch.from_numpy(lens)))
    task = (arr, lens, len(codes), quals, qnames, out_np)
    got = tpool._finalize_se_task_local(indexes[1],
                                        indexes[1].genome.rc_codes(), cfg,
                                        task)
    want = jpool._finalize_se_task_local(
        indexes[0], indexes[0].genome.rc_codes(),
        jc.AlignerConfig(**dataclasses.asdict(cfg)), task)
    want, changed = sam_v1([r.line() for r in want], indexes[0].genome,
                           paired=False)
    assert [r.line() for r in got] == want
    assert changed == 0                     # directional SE: none
    hits_t = tpool.device_results_to_hits(cfg, indexes[1].genome.length, lens,
                                          out_np)
    hits_j = jpool.device_results_to_hits(cfg, indexes[0].genome.length, lens,
                                          out_np)
    assert [tuple(map(dataclasses.astuple, filter(None, h))) for h in hits_t] \
        == [tuple(map(dataclasses.astuple, filter(None, h))) for h in hits_j]
    assert sum(r.flag & 4 == 0 for r in got) > 20


# ---- CLI config tuning -------------------------------------------------------------

GBP_ARGS = {
    "default": [],
    "fast": ["--fast"],
    "sensitive": ["--sensitive"],
    "pbat": ["--pbat"],
    "explicit": ["--fast", "--max-candidates", "32", "--seed-ext", "0"],
    "pe_rate": ["--pe", "--seq1", "a", "--seq2", "b", "-e", "3",
                "--flat-chunks", "4", "--no-indels"],
}


@pytest.mark.parametrize("name", sorted(GBP_ARGS))
def test_autotune_for_genome_at_gbp(name, capsys):
    """Counterpart of tests/test_cli.py::test_gbp_preset_remap, through the
    parsers: the same argv gives the same config in both packages, before
    and after the Gbp-scale tuning."""
    jcli, tcli = both("cli")
    argv = ["search", "ref.fa", "--seq", "r.fq", "--read-bucket", "96",
            *GBP_ARGS[name]]
    cfgs = []
    for cli in (jcli, tcli):
        args = cli.build_parser().parse_args(argv)
        base = cli.make_config(args)
        small = cli.autotune_for_genome(base, args, 100_000_000)
        assert small == base
        cfgs.append((dataclasses.asdict(base), dataclasses.asdict(
            cli.autotune_for_genome(base, args, 3_080_000_000))))
    assert cfgs[0] == cfgs[1]
    err = capsys.readouterr().err
    tuned = cfgs[1][1]
    if name == "default":
        assert (tuned["seed_ext_max"], tuned["seed_ext_occ"],
                tuned["max_candidates"], tuned["max_seed_occ"],
                tuned["locate_budget"], tuned["flat_chunks"]) == \
            (20, 4, 128, 128, 256, 0)
        assert "[bitmapperbs_tpu_torch] 3.08 Gbp genome" in err
    if name == "fast":
        assert (tuned["max_seed_occ"], tuned["locate_budget"],
                tuned["max_candidates"], tuned["seed_ext_max"]) == \
            (128, 256, 64, 20)
    if name == "sensitive":
        assert (tuned["max_seed_occ"], tuned["locate_budget"],
                tuned["max_candidates"], tuned["flat_chunks"]) == \
            (128, 256, 256, 2)
    if name == "pbat":
        assert (tuned["locate_flat_cap"], tuned["flat_chunks"],
                tuned["max_candidates"]) == (192, 3, 128)
    if name == "explicit":
        assert (tuned["max_candidates"], tuned["seed_ext_max"]) == (32, 0)


def test_budget_grouping_helpers():
    jcli, tcli = both("cli")
    cfg_j = both("config")[0].AlignerConfig(read_len_bucket=96)
    cfg_t = both("config")[1].AlignerConfig(read_len_bucket=96)
    for rate, length in ((None, 80), (0.05, 80), (0.05, 150), (0.1, 33)):
        assert tcli._cfg_key(cfg_t, rate, length) == \
            jcli._cfg_key(cfg_j, rate, length)
    for fn in ("_budget_for", "_cfg_key"):
        with pytest.raises(SystemExit) as ej:
            getattr(jcli, fn)(*((0.5, 100) if fn == "_budget_for"
                                else (cfg_j, None, 2000)))
        with pytest.raises(SystemExit) as et:
            getattr(tcli, fn)(*((0.5, 100) if fn == "_budget_for"
                                else (cfg_t, None, 2000)))
        assert str(ej.value) == str(et.value)
    assert tcli._translate_legacy(["--index", "x"]) == ["index", "x"]
    assert tcli.default_prefix("a.fa") == jcli.default_prefix("a.fa")


# ---- multi-host shard planning -------------------------------------------------

MULTIHOST_COPIES = ("HostShard", "_snap_record_start", "_count_newlines",
                    "_offset_of_record", "ByteRangePlan", "plan_byte_range",
                    "shard_path")


@pytest.mark.parametrize("name", MULTIHOST_COPIES)
def test_multihost_helpers_are_verbatim_copies(name):
    """The pure-Python parts of parallel/multihost.py are the reference's,
    line for line (only init_distributed and global_stats differ: gloo
    instead of jax.distributed)."""
    import inspect

    jmh, tmh = both("parallel.multihost")
    assert inspect.getsource(getattr(tmh, name)) == \
        inspect.getsource(getattr(jmh, name))


def test_multihost_plans_equal_the_reference(tmp_path):
    """Seeded FASTQs of varied read lengths (and '@'-leading qualities):
    every host's byte-range plan, SE and PE, and every record-strided
    filter equal the reference's."""
    jfq, tfq = both("io.fastq")
    jmh, tmh = both("parallel.multihost")
    rng = np.random.default_rng(11)
    n = 41
    paths = []
    for mate, (lo, hi) in enumerate(((40, 120), (30, 60))):
        reads = [rng.integers(0, 4, int(rng.integers(lo, hi))).astype(
            np.uint8) for _ in range(n)]
        quals = [("@" if i % 3 else "I") * len(r)
                 for i, r in enumerate(reads)]
        paths.append(str(tmp_path / f"r{mate}.fq"))
        tfq.write_fastq(paths[-1], reads, [f"q{i}" for i in range(n)], quals)
    for H in (1, 2, 3, 4, 7):
        for h in range(H):
            for path2 in (None, paths[1]):
                assert dataclasses.asdict(tmh.plan_byte_range(
                    paths[0], h, H, path2=path2)) == dataclasses.asdict(
                    jmh.plan_byte_range(paths[0], h, H, path2=path2))
            batch = [np.full(3, i, np.uint8) for i in range(9)]
            names = [f"x{i}" for i in range(9)]
            for start in (0, 5, 13):
                got = tmh.HostShard(h, H).filter_batch(batch, names, names,
                                                       start)
                want = jmh.HostShard(h, H).filter_batch(batch, names, names,
                                                        start)
                assert got[1] == want[1] and got[2] == want[2]
            assert tmh.shard_path("o.sam", h, H) == \
                jmh.shard_path("o.sam", h, H)
