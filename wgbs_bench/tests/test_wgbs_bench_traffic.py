"""The traffic generator repeats by seed and keeps its parameters."""
import json
import os

import numpy as np
import pytest

from wgbs_bench import cells, genome as genome_mod, traffic
from wgbs_bench.tests.helpers import TINY_GENOME


@pytest.fixture(scope="module")
def gen():
    return genome_mod.draw(TINY_GENOME)


# generator features that no traffic file of the benchmark uses yet, on
# the parameters of one that does
VARIANTS = {"lowmap": ("scbs", {"foreign_share": 0.6}),
            "repeats": ("wgbs", {"foreign_share": 0.15,
                                 "repeat_anchored_share": 0.4,
                                 "repeat_kind": "tandem",
                                 "repeat_insert": [300, 480]})}


def load(name):
    base, extra = VARIANTS.get(name, (name, {}))
    with open(os.path.join(cells.PKG, "traffic", base + ".json")) as f:
        t = json.load(f)
    t.update(extra, pool=1000)
    return t


def test_genome_repeats_and_records(gen):
    again = genome_mod.draw(TINY_GENOME)
    assert all(np.array_equal(a, b) for a, b in zip(gen.contigs,
                                                    again.contigs))
    assert gen.records == again.records
    kinds = {k for rec in gen.records for _, _, k in rec}
    assert {"dispersed", "line", "tandem"} <= kinds
    assert gen.fasta().startswith(">chr1\n")


@pytest.mark.parametrize("name", ["bulk-se", "wgbs", "scbs", "repeats"])
def test_same_seed_same_pool(gen, name):
    t = load(name)
    a, b = traffic.make_pool(t, gen, 2**31 + 9), traffic.make_pool(t, gen,
                                                                   2**31 + 9)
    c = traffic.make_pool(t, gen, 2**31 + 10)
    flat = (lambda p: np.concatenate([np.concatenate(x) if isinstance(x, tuple)
                                      else x for x in p]))
    assert np.array_equal(flat(a), flat(b))
    assert not np.array_equal(flat(a), flat(c))


@pytest.mark.parametrize("name", ["scbs", "lowmap"])
def test_length_model(gen, name):
    t = load(name)
    lens = np.array([len(r) for r in traffic.make_pool(t, gen, 4)])
    whole = lens == t["read_len"]
    assert whole.sum() == round(1000 * t["trim"]["keep"])
    cut = lens[~whole]
    assert cut.min() >= t["trim"]["min"] and cut.max() <= t["trim"]["max"]
    # the cut lengths are the same set for every seed
    lens2 = np.array([len(r) for r in traffic.make_pool(t, gen, 5)])
    assert np.array_equal(np.sort(lens), np.sort(lens2))


@pytest.fixture(scope="module")
def texts(gen):
    """The genome's text with C and T taken as one, and with G and A."""
    text = "".join("ACGT"[c] for c in np.concatenate(gen.contigs))
    return text.replace("C", "T"), text.replace("G", "A")


def _found(texts, read):
    """Whether an error-free read comes from the genome on any of the four
    bisulfite strands."""
    ct, ga = texts
    s = "".join("ACGT"[c] for c in read)
    rc = "".join("ACGT"[3 - c] for c in read[::-1])
    return (s.replace("C", "T") in ct or rc.replace("G", "A") in ga
            or s.replace("G", "A") in ga or rc.replace("C", "T") in ct)


@pytest.mark.parametrize("name,share", [("scbs", 0.15), ("lowmap", 0.6)])
def test_foreign_share(gen, texts, name, share):
    t = load(name)
    t.update(pool=200, sub_rate=0.0, indel_rate=0.0, trim=None,
             foreign_share=share)
    pool = traffic.make_pool(t, gen, 6)
    found = sum(_found(texts, r) for r in pool)
    assert found == 200 - round(200 * share)


def test_strand_mix(gen):
    """Directional pairs: mate 1 is C->T converted (OT / OB), mate 2 G->A;
    PBAT reads come from all four strands."""
    t = load("wgbs")
    t.update(pool=200, sub_rate=0.0, indel_rate=0.0, foreign_share=0.0,
             meth={"cpg": 0.0, "other": 0.0})
    pool = traffic.make_pool(t, gen, 7)
    assert all((r1 != 1).all() and (r2 != 2).all() for r1, r2 in pool)
    t = load("scbs")
    t.update(pool=400, sub_rate=0.0, indel_rate=0.0, foreign_share=0.0,
             trim=None, meth={"cpg": 0.0, "other": 0.0})
    reads = traffic.make_pool(t, gen, 8)
    no_c = sum((r != 1).all() for r in reads)
    no_g = sum((r != 2).all() for r in reads)
    assert 120 < no_c < 280 and 120 < no_g < 280
    t = load("bulk-se")         # directional: OT / OB reads, no C
    t.update(pool=200, sub_rate=0.0, indel_rate=0.0,
             meth={"cpg": 0.0, "other": 0.0})
    assert all((r != 1).all() for r in traffic.make_pool(t, gen, 8))


def test_error_rates(gen):
    """The stated rates: of the bulk-se traffic's 150 bp reads, the share
    with an indel is near 1 - (1 - indel_rate) ** 150."""
    t = load("bulk-se")
    t.update(pool=4000, meth={"cpg": 1.0, "other": 1.0})
    clean = dict(t, sub_rate=0.0, indel_rate=0.0)
    a = traffic.make_pool(t, gen, 12)
    b = traffic.make_pool(clean, gen, 12)
    assert t["sub_rate"] < 0.01 and t["indel_rate"] < 0.001
    diff = np.array([(x != y).mean() for x, y in zip(a, b)])
    want = 1 - (1 - t["indel_rate"]) ** 150
    shifted = (diff > 0.2).mean()       # an indel shifts the read's rest
    assert 0.4 * want < shifted < 2.0 * want


def test_repeat_anchored_share(gen):
    """40 % of the repeats traffic's pairs have one mate in a tandem array
    and the other outside it."""
    t = load("repeats")
    t.update(pool=100, sub_rate=0.0, indel_rate=0.0, foreign_share=0.0,
             meth={"cpg": 1.0, "other": 1.0})
    pool = traffic.make_pool(t, gen, 9)
    text = np.concatenate(gen.contigs)
    offs = np.cumsum([0] + [len(c) for c in gen.contigs])
    tandem = np.zeros(len(text), dtype=bool)
    for k, rec in enumerate(gen.records):
        for s, e, kind in rec:
            if kind == "tandem":
                tandem[offs[k] + s:offs[k] + e] = True
    raw = text.tobytes()

    def where(read):
        for r in (read, 3 - read[::-1]):
            p = raw.find(r.astype(np.uint8).tobytes())
            if p >= 0:
                return p
        return -1

    anchored = 0
    for r1, r2 in pool:
        p1, p2 = where(r1), where(r2)
        assert p1 >= 0 and p2 >= 0
        ins = [tandem[p:p + len(r)].all() for p, r in ((p1, r1), (p2, r2))]
        out = [not tandem[p:p + len(r)].any() for p, r in ((p1, r1), (p2, r2))]
        anchored += (ins[0] and out[1]) or (ins[1] and out[0])
    assert anchored >= 40
