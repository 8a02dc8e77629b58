"""The reference on a tiny genome: its records against the port's pipeline
(plain PyTorch on the CPU), its records against the genome itself, and its
parts against plain definitions."""
import dataclasses

import numpy as np
import pytest

from wgbs_bench import genome as genome_mod, traffic
from wgbs_bench.reference import align, finalize, index as ref_index, \
    map_pairs, map_reads
from wgbs_bench.reference import constants as K
from wgbs_bench.reference.config import Spec
from wgbs_bench.tests.helpers import TINY_GENOME

MAPQ = {"mapq_by_gap": [0, 10, 20, 30], "mapq_max": 42}


@pytest.fixture(scope="module")
def world():
    import torch

    from bitmapperbs_tpu_torch.index.build import build_index
    from bitmapperbs_tpu_torch.index.device import upload_index

    g = genome_mod.draw(TINY_GENOME)
    idx = build_index(g.fasta())
    return g, idx, upload_index(idx, torch.device("cpu")), ref_index.Index(
        ref_index.Genome(g.names, g.contigs))


def spec_of(cfg):
    return Spec(**{f.name: getattr(cfg, f.name)
                   for f in dataclasses.fields(Spec) if hasattr(cfg, f.name)},
                **MAPQ)


SE = {"mode": "se", "pool": 128, "read_len": 141, "clip5": 9,
      "meth": {"cpg": 0.75, "other": 0.01}, "sub_rate": 0.01,
      "indel_rate": 0.005, "foreign_share": 0.15,
      "trim": {"keep": 0.8, "min": 20, "max": 140}}
PE = {"mode": "pe", "pool": 64, "read_len": 150, "insert": [150, 480],
      "meth": {"cpg": 0.75, "other": 0.01}, "sub_rate": 0.01,
      "indel_rate": 0.005, "foreign_share": 0.15,
      "repeat_anchored_share": 0.4, "repeat_kind": "tandem",
      "repeat_insert": [300, 480]}


def port_se(world, cfg, pool, names):
    import torch

    from bitmapperbs_tpu_torch.models.host import map_batch

    torch.set_num_threads(1)
    g, idx, dix, _ = world
    return [r.line() for r in map_batch(
        idx, dix, cfg, pool, ["I" * len(r) for r in pool], names)]


def port_pe(world, cfg, pool, names):
    from bitmapperbs_tpu_torch.models.host import map_batch_pe

    g, idx, dix, _ = world
    return [r.line() for r in map_batch_pe(
        idx, dix, cfg, pool, [("I" * len(a), "I" * len(b)) for a, b in pool],
        names)]


@pytest.mark.parametrize("caps", [
    {}, {"max_seed_occ": 16, "locate_budget": 24, "max_candidates": 8},
    {"seed_ext_max": 20, "max_candidates": 16, "locate_budget": 40}],
    ids=["defaults", "small_caps", "seed_extension"])
def test_directional_se_equals_the_port(world, caps):
    """Directional reads (OT / OB): every record as the port writes it."""
    from bitmapperbs_tpu_torch.config import AlignerConfig

    cfg = AlignerConfig(max_errors=4, batch_size=128, **caps)
    pool = traffic.make_pool(dict(SE, protocols=["OT", "OB"]), world[0], 11)
    names = [f"r{i}" for i in range(len(pool))]
    assert map_reads(world[3], spec_of(cfg), pool, names) == \
        port_se(world, cfg, pool, names)


def _ga_gapped(line: str) -> bool:
    f = line.split("\t")
    return "XR:Z:GA" in f and any(op in f[5] for op in "ID")


MATE_FIELDS = (1, 6, 7, 8)      # FLAG, RNEXT, PNEXT, TLEN


@pytest.mark.parametrize("mode", ["pbat_se", "pe"])
def test_the_port_differs_only_where_found(world, mode):
    """PBAT SE and directional PE, where the port's records differ from the
    reference's only as PERF.md's open questions say: the CIGAR (and with
    it NM, MD, XM) of a G->A-read hit with an indel, which the port writes
    reversed; and in PE the mate fields that SAM v1 defines and the port
    leaves at '*' / 0.  Everything else agrees, record for record."""
    from bitmapperbs_tpu_torch.config import AlignerConfig

    if mode == "pe":
        cfg = AlignerConfig(max_errors=4, paired=True, max_insert=500,
                            seed_ext_max=20, max_candidates=128,
                            batch_size=64)
        pool = traffic.make_pool(PE, world[0], 12)
        names = [f"p{i}" for i in range(len(pool))]
        want = map_pairs(world[3], spec_of(cfg), pool, names)
        got = port_pe(world, cfg, pool, names)
    else:
        cfg = AlignerConfig(max_errors=4, non_directional=True,
                            batch_size=128)
        pool = traffic.make_pool(dict(SE, protocols=[
            "OT", "OB", "CTOT", "CTOB"]), world[0], 13)
        names = [f"r{i}" for i in range(len(pool))]
        want = map_reads(world[3], spec_of(cfg), pool, names)
        got = port_se(world, cfg, pool, names)
    assert len(want) == len(got)
    for w, x in zip(want, got):
        if w == x:
            continue
        wf, xf = w.split("\t"), x.split("\t")
        if _ga_gapped(w):
            assert wf[5] != xf[5] and sorted(wf[5]) == sorted(xf[5]), (w, x)
            continue
        assert mode == "pe", (w, x)
        assert [a for k, a in enumerate(wf) if k not in MATE_FIELDS] == \
            [a for k, a in enumerate(xf) if k not in MATE_FIELDS], (w, x)


def _walk_nm(genome, line: str) -> int:
    """Edits of a record's SEQ against the genome at POS by its CIGAR, the
    strand's bisulfite change (XG) counted as a match."""
    f = line.split("\t")
    q = int(genome.offsets[genome.names.index(f[2])]) + int(f[3]) - 1
    seq = "ACGTN"
    top = "XG:Z:CT" in f
    i, nm, num = 0, 0, ""
    for ch in f[5]:
        if ch.isdigit():
            num += ch
            continue
        n, num = int(num), ""
        if ch == "M":
            for _ in range(n):
                g, r = seq[genome.codes[q]], f[9][i]
                ok = g != "N" and (g == r or (g, r) == (
                    ("C", "T") if top else ("G", "A")))
                nm += not ok
                q, i = q + 1, i + 1
        elif ch == "I":
            nm, i = nm + n, i + n
        else:
            nm, q = nm + n, q + n
    return nm


def test_records_hold_against_the_genome(world):
    """Every mapped record's CIGAR, walked over the genome, has the NM it
    states and no more than -e edits, on all four strands."""
    from bitmapperbs_tpu_torch.config import AlignerConfig

    cfg = AlignerConfig(max_errors=4, non_directional=True, batch_size=128)
    pool = traffic.make_pool(dict(SE, protocols=["OT", "OB", "CTOT", "CTOB"],
                                  indel_rate=0.02), world[0], 14)
    lines = map_reads(world[3], spec_of(cfg), pool,
                      [f"r{i}" for i in range(len(pool))])
    gapped = 0
    for line in lines:
        f = line.split("\t")
        if int(f[1]) & K.FLAG_UNMAPPED:
            continue
        nm = int(next(t for t in f if t.startswith("NM:i:"))[5:])
        assert _walk_nm(world[3].genome, line) == nm <= 4, line
        gapped += _ga_gapped(line)
    assert gapped >= 3


def test_alignment_costs_the_edit_distance():
    """finalize's own alignment costs what the scoring's edit distance says,
    and its CIGAR consumes the read."""
    rng = np.random.default_rng(2)
    for _ in range(30):
        read = rng.integers(0, 4, 40).astype(np.uint8)
        win = rng.integers(0, 4, 48).astype(np.uint8)
        win[4:44] = read
        win[rng.integers(0, 48, 3)] = rng.integers(0, 4, 3)
        win = np.insert(win, rng.integers(5, 40), rng.integers(0, 4))[:48]
        start, ops = finalize.align_end_to_end([int(x) for x in win],
                                               [int(x) for x in read])
        cost = 0
        i, j = 0, start
        for op in ops:
            if op == "M":
                cost += not align.asym_match(win[j:j + 1], read[i:i + 1])[0]
                i, j = i + 1, j + 1
            elif op == "I":
                cost, i = cost + 1, i + 1
            else:
                cost, j = cost + 1, j + 1
        assert i == len(read)
        assert cost == align.edit_distance(win, read)


def test_edit_distances_equal_edit_distance():
    rng = np.random.default_rng(1)
    read = rng.integers(0, 4, 60).astype(np.uint8)
    wins = rng.integers(0, 5, (40, 68)).astype(np.uint8)
    for k in range(0, 40, 2):       # half of them near the read
        wins[k, 4:64] = read
        wins[k, rng.integers(0, 68, 3)] = rng.integers(0, 4, 3)
    for cap in (0, 4, 100):
        got = align.edit_distances(wins, read, cap)
        want = np.array([align.edit_distance(w, read) for w in wins])
        assert np.array_equal(np.minimum(got, cap + 1),
                              np.minimum(want, cap + 1))
        assert np.array_equal(got[want <= cap], want[want <= cap])


@pytest.mark.parametrize("cap", [2, 1 << 10])
def test_scan_counts_finds_and_suffix_order(monkeypatch, cap):
    """The scan counts every pattern and finds where it is, in steps
    smaller than the text too; a short pattern past the cap keeps its count
    and no positions."""
    monkeypatch.setattr(ref_index, "CHUNK", 7)
    conv = np.array([1, 2, 3, 1, 2, 3, 1, 2, 1, 1, 2, 3] * 3, dtype=np.uint8)
    block = ref_index.Block(conv, cap=cap)
    text = conv.tobytes()
    pats = [[1, 2], [1, 2, 3, 1], [3, 3], [2, 3] * 9, [2, 1, 1, 2, 3],
            [3, 1, 2, 3, 1, 2, 1, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2]]
    block.locate([np.array(p, dtype=np.uint8) for p in pats])
    for pat in pats:
        p = np.array(pat, dtype=np.uint8)
        want = [i for i in range(len(conv))
                if text[i:i + len(p)] == p.tobytes()]
        assert block.count(p) == len(want)
        if len(want) > cap and len(p) <= ref_index.KMER:
            with pytest.raises(ValueError):
                block.find(p)
            continue
        assert [int(x) for x in block.find(p)] == want
        ordered = [int(x) for x in block.suffix_sorted(block.find(p))]
        assert ordered == sorted(want, key=lambda i: text[i:])
