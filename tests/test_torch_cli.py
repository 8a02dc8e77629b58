"""PyTorch port CLI: `search` SAM records equal the reference CLI's (single
end and `--pe`), the GPU platform refuses to fall back to the CPU, `--pe`
needs both mate files, `--oracle` and `--profile` work as the reference's,
the mesh over several devices (replicated and `--shard-index`) writes the
single device's records, and the package never imports jax.  The
reference's records are taken to their SAM v1 form first (tests/sam_v1.py:
the G->A gapped records and PE mate fields that the JAX package writes
otherwise), and its stats with them."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bitmapperbs_tpu.cli import main as jmain  # noqa: E402
from bitmapperbs_tpu.index.build import parse_fasta  # noqa: E402
from bitmapperbs_tpu.io.fastq import write_fastq  # noqa: E402
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,  # noqa: E402
                                            simulate_pairs, simulate_reads)
from bitmapperbs_tpu_torch.cli import main  # noqa: E402
from sam_v1 import restat, sam_v1  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    fa = random_genome_fasta(np.random.default_rng(12), contigs=(4000, 1500))
    (d / "ref.fa").write_text(fa)
    sims = simulate_reads(parse_fasta(fa), 40, read_len=80, seed=4,
                          sub_rate=0.01, indel_rate=0.005)
    write_fastq(d / "reads.fq", [s.codes for s in sims],
                quals=[s.qual for s in sims])
    pairs = simulate_pairs(parse_fasta(fa), 24, read_len=80, seed=6,
                           min_insert=150, max_insert=300, sub_rate=0.01,
                           indel_rate=0.005)
    for mate in (0, 1):
        write_fastq(d / f"pairs_{mate + 1}.fq", [p[mate].codes for p in pairs],
                    qnames=[f"pair{i}" for i in range(len(pairs))],
                    quals=[p[mate].qual for p in pairs])
    assert main(["index", str(d / "ref.fa")]) == 0
    return d


def records(path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith("@PG")]


def v1_records(d, path, paired: bool) -> tuple[list[str], int]:
    """records(path) of a reference run in SAM v1 form, and how many
    changed."""
    return sam_v1(records(path), parse_fasta(str(d / "ref.fa")), paired)


@pytest.mark.parametrize("extra", [[], ["--pbat", "-e", "0.05"]])
def test_search_matches_reference_cli(workdir, extra):
    d = workdir
    common = ["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
              "--batch-size", "16", "--platform", "cpu", *extra]
    assert main([*common, "-o", str(d / "port.sam"),
                 "--stats-json", str(d / "port.json")]) == 0
    assert jmain([*common, "--single-device", "-o", str(d / "ref.sam"),
                  "--stats-json", str(d / "ref.json")]) == 0
    got, (want, changed) = records(d / "port.sam"), v1_records(
        d, d / "ref.sam", paired=False)
    assert got == want
    assert changed == 0
    assert sum(not ln.startswith("@") for ln in got) == 40
    assert (d / "port.json").read_text() == (d / "ref.json").read_text()


@pytest.mark.parametrize("extra", [[], ["--pbat", "-e", "0.05"]])
def test_search_pe_matches_reference_cli(workdir, extra):
    d = workdir
    common = ["search", str(d / "ref.fa"), "--pe", "--seq1",
              str(d / "pairs_1.fq"), "--seq2", str(d / "pairs_2.fq"),
              "--batch-size", "16", "--min", "100", "--max", "400",
              "--platform", "cpu", *extra]
    assert main([*common, "-o", str(d / "port_pe.sam"),
                 "--stats-json", str(d / "port_pe.json")]) == 0
    assert jmain([*common, "--single-device", "-o", str(d / "ref_pe.sam"),
                  "--stats-json", str(d / "ref_pe.json")]) == 0
    got, (want, changed) = records(d / "port_pe.sam"), v1_records(
        d, d / "ref_pe.sam", paired=True)
    assert got == want
    assert changed > 0
    body = [ln for ln in got if not ln.startswith("@")]
    assert len(body) == 48
    assert sum(int(ln.split("\t")[1]) & 0x2 > 0 for ln in body) > 24
    assert (d / "port_pe.json").read_text() == restat(
        (d / "ref_pe.json").read_text(), records(d / "ref_pe.sam"), want)


PE_OPTIONS = {"t2_rg": ["-t", "2", "--rg", "lib1"], "fast": ["--fast"],
              "sensitive": ["--sensitive"], "pbat": ["--pbat"]}


@pytest.mark.parametrize("name", PE_OPTIONS)
def test_search_pe_options_match_reference_cli(workdir, name):
    """`--pe` under a finalize pool of two with a read group, `--fast`,
    `--sensitive` and `--pbat`: the records equal the reference CLI's in
    their SAM v1 form."""
    d = workdir
    common = ["search", str(d / "ref.fa"), "--pe", "--seq1",
              str(d / "pairs_1.fq"), "--seq2", str(d / "pairs_2.fq"),
              "--batch-size", "16", "--min", "100", "--max", "400",
              "--platform", "cpu", *PE_OPTIONS[name]]
    assert main([*common, "-o", str(d / f"po_{name}.sam")]) == 0
    assert jmain([*common, "--single-device", "-o",
                  str(d / f"jpo_{name}.sam")]) == 0
    want, changed = v1_records(d, d / f"jpo_{name}.sam", paired=True)
    assert records(d / f"po_{name}.sam") == want
    assert changed > 0
    assert sum(not ln.startswith("@") for ln in want) == 48


@pytest.mark.parametrize("mate", ["--seq1", "--seq2"])
def test_pe_needs_both_mates(workdir, capsys, mate):
    """`--pe` with one mate file exits 2 with the reference's message."""
    d = workdir
    args = ["search", str(d / "ref.fa"), "--pe", mate,
            str(d / "pairs_1.fq"), "--platform", "cpu"]
    assert main(args) == 2
    err = capsys.readouterr().err
    assert jmain(args) == 2
    assert err == capsys.readouterr().err == \
        "error: --pe requires --seq1 and --seq2\n"


def test_platform_auto_needs_a_gpu(workdir, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d = workdir
    args = ["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
            "-o", str(d / "x.sam")]
    assert main(args) == 2
    assert main([*args, "--platform", "gpu"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (d / "x.sam").exists()


@pytest.fixture
def eight_devices(monkeypatch):
    """The CLI's local devices: eight CPU devices, as the reference's tests
    run its mesh on eight virtual CPU devices."""
    from bitmapperbs_tpu_torch import cli

    monkeypatch.setattr(cli, "_local_devices",
                        lambda platform: [torch.device("cpu")] * 8)


@pytest.mark.parametrize("pe", [False, True])
def test_search_on_a_mesh_matches_single_device_and_reference(
        workdir, capsys, eight_devices, pe):
    """Over eight devices the CLI maps on the mesh by default, and with
    --shard-index 4 on a 2 x 4 mesh with the index split; the records equal
    --single-device's and the reference CLI's --shard-index 4 run's."""
    d = workdir
    tag = "pe" if pe else "se"
    if pe:
        common = ["search", str(d / "ref.fa"), "--pe", "--seq1",
                  str(d / "pairs_1.fq"), "--seq2", str(d / "pairs_2.fq"),
                  "--min", "100", "--max", "400"]
    else:
        common = ["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq")]
    common += ["--batch-size", "8", "--read-bucket", "96", "--platform",
               "cpu"]
    runs = {"mesh": [], "shard": ["--shard-index", "4"],
            "one": ["--single-device"]}
    meshes = {"mesh": "{'data': 8}", "shard": "{'data': 2, 'idx': 4}"}
    for name, extra in runs.items():
        assert main([*common, *extra, "-o", str(d / f"m_{tag}_{name}.sam")
                     ]) == 0
        err = capsys.readouterr().err
        if name in meshes:
            assert f"mapping over 8 devices (mesh {meshes[name]})" in err
        else:
            assert "mapping over" not in err
    assert jmain([*common, "--shard-index", "4", "-o",
                  str(d / f"m_{tag}_ref.sam")]) == 0
    want, changed = v1_records(d, d / f"m_{tag}_ref.sam", paired=pe)
    assert (changed > 0) == pe
    for name in runs:
        assert records(d / f"m_{tag}_{name}.sam") == want, name
    assert sum(not ln.startswith("@") for ln in want) == (48 if pe else 40)


def test_rate_groups_on_a_mesh_reuse_the_index(workdir, eight_devices,
                                               monkeypatch):
    """-e RATE maps each (budget, bucket) group with its own mappers on the
    mesh that the first upload built: the index is uploaded once, and the
    records equal --single-device's (the counterpart of the reference's
    test_multichip_with_rate_groups)."""
    from bitmapperbs_tpu_torch.parallel import shard

    d = workdir
    sims = simulate_reads(parse_fasta((d / "ref.fa").read_text()), 24,
                          read_len=50, seed=41, sub_rate=0.02)
    long = simulate_reads(parse_fasta((d / "ref.fa").read_text()), 24,
                          read_len=100, seed=42, sub_rate=0.02)
    reads = [s.codes for pair in zip(sims, long) for s in pair]
    write_fastq(d / "mix.fq", reads, [f"m{i}" for i in range(48)],
                ["I" * len(r) for r in reads])
    uploads = []
    real = shard.upload_mesh_index
    monkeypatch.setattr(shard, "upload_mesh_index",
                        lambda *a: uploads.append(a) or real(*a))
    common = ["search", str(d / "ref.fa"), "--seq", str(d / "mix.fq"),
              "--platform", "cpu", "--batch-size", "24", "--read-bucket",
              "128", "-e", "0.04"]
    assert main([*common, "--shard-index", "2", "-o",
                 str(d / "rate_mesh.sam")]) == 0
    assert len(uploads) == 1
    assert main([*common, "--single-device", "-o",
                 str(d / "rate_one.sam")]) == 0
    assert len(uploads) == 1
    got = records(d / "rate_mesh.sam")
    assert got == records(d / "rate_one.sam")
    assert sum(not ln.startswith("@") for ln in got) == 48


@pytest.mark.parametrize("extra", [["--platform", "cpu"],
                                   ["--single-device"]])
def test_shard_index_needs_two_devices(workdir, capsys, extra):
    """--shard-index on one device (the CPU platform's one, or
    --single-device) exits 2 with the reference's message."""
    d = workdir
    args = ["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
            "--read-bucket", "96", "--shard-index", "2", "-o",
            str(d / "x_shard.sam"), *extra]
    if "--single-device" in extra:
        args += ["--platform", "cpu"]
    assert main(args) == 2
    err = capsys.readouterr().err
    assert jmain([*args, "--single-device", "--platform", "cpu"]) == 2
    assert err == capsys.readouterr().err == \
        "error: --shard-index needs >1 local device\n"


def test_shard_index_must_divide_the_devices(workdir, capsys,
                                             eight_devices):
    d = workdir
    assert main(["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
                 "--platform", "cpu", "--shard-index", "3", "-o",
                 str(d / "x_div.sam")]) == 2
    assert capsys.readouterr().err.endswith(
        "error: --shard-index 3 does not divide device count 8\n")


@pytest.mark.parametrize("pe", [False, True])
def test_oracle_matches_reference_and_device(workdir, capsys, pe):
    """--oracle maps through the port's numpy oracle: records equal to the
    reference CLI's --oracle and to the port's device path on the CPU; with
    the default --platform auto it needs no CUDA device."""
    d = workdir
    if pe:
        common = ["search", str(d / "ref.fa"), "--pe", "--seq1",
                  str(d / "pairs_1.fq"), "--seq2", str(d / "pairs_2.fq"),
                  "--min", "100", "--max", "400"]
    else:
        common = ["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq")]
    common += ["--batch-size", "16"]
    tag = "pe" if pe else "se"
    assert main([*common, "--oracle", "-o", str(d / f"or_{tag}.sam")]) == 0
    assert "no CUDA device" not in capsys.readouterr().err
    assert jmain([*common, "--oracle", "-o", str(d / f"jor_{tag}.sam")]) == 0
    assert main([*common, "--platform", "cpu", "-o",
                 str(d / f"dev_{tag}.sam")]) == 0
    got = records(d / f"or_{tag}.sam")
    want, changed = v1_records(d, d / f"jor_{tag}.sam", paired=pe)
    assert got == want == records(d / f"dev_{tag}.sam")
    assert (changed > 0) == pe
    assert sum(not ln.startswith("@") for ln in got) == (48 if pe else 40)


def test_profile_writes_a_chrome_trace(workdir, capsys):
    """--profile DIR: a torch.profiler Chrome trace that parses as JSON and
    holds events; the stderr lines name the file and give the map / write
    stage walls, one of each per written group; records unchanged."""
    import re

    from bitmapperbs_tpu_torch.utils.profiling import trace_path

    d = workdir
    common = ["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
              "--batch-size", "16", "--platform", "cpu"]
    prof = d / "prof"
    assert main([*common, "-o", str(d / "prof.sam"), "--profile",
                 str(prof)]) == 0
    path = trace_path(str(prof))
    err = capsys.readouterr().err
    assert f"profiler trace -> {path}" in err
    stages = re.search(r"stages: map=[0-9.]+ms/(\d+)x  write=[0-9.]+ms/(\d+)x",
                       err)
    assert stages and stages[1] == stages[2] and int(stages[1]) >= 1, err
    trace = json.load(open(path))
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    names = {ev.get("name", "") for ev in events}
    assert len(events) > 100 and any("aten::" in n for n in names)
    assert main([*common, "-o", str(d / "noprof.sam")]) == 0
    assert records(d / "prof.sam") == records(d / "noprof.sam")


def test_stage_timer_accumulates_and_reports():
    """The recorder (utils/profiling), which replaced StageTimer, keeps its
    cases: spans of one name accumulate with their count, and the report
    lists them by name as `name=<ms>ms/<n>x`."""
    from bitmapperbs_tpu_torch.utils.profiling import (REC, device_trace,
                                                       report, span, totals)

    REC.start()
    try:
        for _ in range(3):
            with span("seed"):
                torch.ones(8).sum()
        with span("verify"):
            pass
    finally:
        snap = REC.stop()
    tot = totals(snap)
    assert {k: n for k, (_, n) in tot.items()} == {"seed": 3, "verify": 1}
    assert tot["seed"][0] > 0
    rep = report(snap)
    assert rep.startswith("seed=") and "ms/3x" in rep and "ms/1x" in rep
    assert rep.index("seed=") < rep.index("verify=")
    with device_trace(None):                # no directory: a no-op
        pass


def test_resample_matches_reference_cli(workdir, capsys):
    """`resample` is ported: the same artifact bytes as the reference CLI,
    in place and with --out, and the resampled index searches to the same
    SAM as before (locate walks half as far)."""
    import shutil

    d = workdir
    src = str(d / "ref.fa.btidx")
    for name in ("rs_port", "rs_ref"):
        for ext in (".bin", ".json"):
            shutil.copy(src + ext, str(d / name) + ext)
    assert main(["resample", str(d / "rs_port"), "--sa-rate", "2"]) == 0
    assert "sa_rate 4 -> 2" in capsys.readouterr().err
    assert jmain(["resample", str(d / "rs_ref"), "--sa-rate", "2"]) == 0
    for ext in (".bin", ".json"):
        assert (d / f"rs_port{ext}").read_bytes() == \
            (d / f"rs_ref{ext}").read_bytes()
    assert (d / "rs_port.bin").read_bytes() != (d / "ref.fa.btidx.bin"
                                                ).read_bytes()
    assert main(["resample", src, "--sa-rate", "2", "--out",
                 str(d / "rs_out")]) == 0
    assert (d / "rs_out.bin").read_bytes() == (d / "rs_ref.bin").read_bytes()
    common = ["search", "--seq", str(d / "reads.fq"), "--batch-size", "16",
              "--platform", "cpu"]
    assert main([*common[:1], str(d / "rs_out"), *common[1:], "-o",
                 str(d / "rs.sam")]) == 0
    assert main([*common[:1], str(d / "ref.fa"), *common[1:], "-o",
                 str(d / "base.sam")]) == 0
    assert records(d / "rs.sam") == records(d / "base.sam")


def test_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bitmapperbs_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.') if not m.name.endswith('__main__')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 11, mods\n"
        "assert 'bitmapperbs_tpu_torch.models.paired' in mods, mods\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
