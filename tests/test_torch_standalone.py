"""PyTorch port stands alone: importing every module of the package and
running `index` + `search` on the CPU (finalize-pool workers included) loads
neither jax nor anything of the reference package; no source file imports
them; and the copied constants and config equal the reference's name for
name."""
import dataclasses
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from bitmapperbs_tpu import config as jconfig  # noqa: E402
from bitmapperbs_tpu import constants as JK  # noqa: E402
from bitmapperbs_tpu_torch import config as tconfig  # noqa: E402
from bitmapperbs_tpu_torch import constants as TK  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "bitmapperbs_tpu_torch")

# runs in a fresh interpreter: every module imported, a toy index built and
# saved, SE and PE search through the CLI with a 2-worker finalize pool,
# then a pool of the same kind is asked what its workers have loaded
SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
import numpy as np
import bitmapperbs_tpu_torch as p

mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')
        if not m.name.endswith('__main__')]
for m in mods:
    importlib.import_module(m)
assert len(mods) >= 30, mods
assert {'bitmapperbs_tpu_torch.parallel.multihost',
        'bitmapperbs_tpu_torch.parallel.mesh',
        'bitmapperbs_tpu_torch.parallel.shard',
        'bitmapperbs_tpu_torch.utils.profiling'} <= set(mods), mods

from bitmapperbs_tpu_torch.cli import main
from bitmapperbs_tpu_torch.config import AlignerConfig
from bitmapperbs_tpu_torch.index.build import load_index, parse_fasta
from bitmapperbs_tpu_torch.io.fastq import write_fastq
from bitmapperbs_tpu_torch.models.pool import make_finalize_pool
from bitmapperbs_tpu_torch.utils.simulate import (random_genome_fasta,
                                                  simulate_pairs,
                                                  simulate_reads)

def foreign(names):
    return sorted(n for n in names
                  if n == 'jax' or n.startswith('jax.') or n == 'jaxlib'
                  or n == 'bitmapperbs_tpu' or n.startswith('bitmapperbs_tpu.'))

with tempfile.TemporaryDirectory() as d:
    fa = random_genome_fasta(np.random.default_rng(1), contigs=(3000, 1200))
    ref = os.path.join(d, 'ref.fa')
    open(ref, 'w').write(fa)
    g = parse_fasta(fa)
    sims = simulate_reads(g, 24, read_len=80, seed=2, sub_rate=0.01)
    write_fastq(os.path.join(d, 'r.fq'), [s.codes for s in sims],
                quals=[s.qual for s in sims])
    pairs = simulate_pairs(g, 12, read_len=80, seed=3, min_insert=150,
                           max_insert=300)
    for k in (0, 1):
        write_fastq(os.path.join(d, f'p{k}.fq'), [q[k].codes for q in pairs],
                    qnames=[f'p{i}' for i in range(len(pairs))],
                    quals=[q[k].qual for q in pairs])
    assert main(['index', ref]) == 0
    assert main(['search', ref, '--seq', os.path.join(d, 'r.fq'), '-o',
                 os.path.join(d, 'se.sam'), '--platform', 'cpu', '-t', '2',
                 '--batch-size', '16']) == 0
    assert main(['search', ref, '--pe', '--seq1', os.path.join(d, 'p0.fq'),
                 '--seq2', os.path.join(d, 'p1.fq'), '-o',
                 os.path.join(d, 'pe.sam'), '--platform', 'cpu', '-t', '2',
                 '--min', '100', '--max', '400']) == 0
    # the host oracle, a profiler trace, the cursor written per group and a
    # resume, and the stats all_reduce of a one-process gloo group
    assert main(['search', ref, '--seq', os.path.join(d, 'r.fq'), '-o',
                 os.path.join(d, 'or.sam'), '--oracle', '--profile',
                 os.path.join(d, 'prof'), '--batch-size', '8']) == 0
    assert not os.path.exists(os.path.join(d, 'or.sam.cursor'))
    open(os.path.join(d, 'or.sam.cursor'), 'w').write(
        '{"record": 0, "offset": 0, "offset2": 0, "out_pos": 0}')
    assert main(['search', ref, '--seq', os.path.join(d, 'r.fq'), '-o',
                 os.path.join(d, 'or.sam'), '--platform', 'cpu', '--resume',
                 '--batch-size', '8']) == 0
    from bitmapperbs_tpu_torch.io.stats import MapStats
    from bitmapperbs_tpu_torch.parallel import multihost
    import socket
    s = socket.socket(); s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]; s.close()
    multihost.dist.init_process_group('gloo', rank=0, world_size=1,
                                      init_method=f'tcp://127.0.0.1:{port}')
    assert multihost.global_stats(MapStats(total=3))['total'] == 3
    multihost.finalize_distributed()
    n_se = sum(not ln.startswith('@') for ln in open(os.path.join(d, 'se.sam')))
    n_pe = sum(not ln.startswith('@') for ln in open(os.path.join(d, 'pe.sam')))
    assert (n_se, n_pe) == (24, 24), (n_se, n_pe)
    pool = make_finalize_pool(load_index(ref + '.btidx'), AlignerConfig(), 2)
    try:
        loaded = pool.apply(eval, ("sorted(__import__('sys').modules)",))
    finally:
        pool.terminate()
assert 'bitmapperbs_tpu_torch.models.pool' in loaded, loaded
assert not foreign(loaded), ('worker', foreign(loaded))
assert not foreign(sys.modules), ('parent', foreign(sys.modules))
print('OK', len(mods))
"""


def test_port_runs_without_jax_or_the_reference_package():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().startswith("OK")


def test_no_source_imports_jax_or_the_reference_package():
    pat = re.compile(
        r"^\s*(?:from|import)\s+(?:jax|jaxlib|bitmapperbs_tpu)(?:[.\s]|$)",
        re.M)
    # import statements carried inside string literals (spawned runners)
    quoted = re.compile(
        r"[\"'](?:from|import)\s+(?:jax|jaxlib|bitmapperbs_tpu)[.\s]")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(PKG):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) >= 35
    bad = []
    for path in files:
        with open(path) as f:
            src = f.read()
        if pat.search(src) or quoted.search(src):
            bad.append(os.path.relpath(path, ROOT))
    assert not bad, bad


def test_constants_equal_the_reference():
    names = [n for n in dir(JK) if not n.startswith("_")]
    assert len(names) > 30
    for n in names:
        want, got = getattr(JK, n), getattr(TK, n)
        if type(want).__module__ == "builtins" and not callable(want):
            assert got == want, n
        elif hasattr(want, "dtype"):
            assert got.dtype == want.dtype and (got == want).all(), n
    assert sorted(n for n in dir(TK) if not n.startswith("_")) == sorted(names)


def test_config_fields_equal_the_reference():
    jf = dataclasses.fields(jconfig.AlignerConfig)
    tf = dataclasses.fields(tconfig.AlignerConfig)
    assert [(f.name, f.type, f.default) for f in tf] == \
        [(f.name, f.type, f.default) for f in jf]
    ref = jconfig.AlignerConfig(
        max_errors=3, seed_ext_max=20, max_candidates=128, paired=True,
        mesh_shape=(2, 2), mesh_axes=("data", "index"), use_pallas=False,
        sam_rg="rg1", flat_chunks=2)
    got = tconfig.AlignerConfig.from_reference(ref)
    assert isinstance(got, tconfig.AlignerConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for L, F in ((10_000_000, 2), (64_000_000, 2), (3_080_000_000, 4)):
        assert got.resolve_flat_cap(L, F) == ref.resolve_flat_cap(L, F)
    assert (got.num_seeds, got.band) == (ref.num_seeds, ref.band)
