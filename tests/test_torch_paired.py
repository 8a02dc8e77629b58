"""PyTorch port, paired-end: the mate-rescue scan's plain version equals the
JAX verify.myers_scan, map_batch_pe_device equals the JAX CPU
map_batch_pe_device key for key (nested se1/se2 included) in every
pipeline configuration, and the port's map_batch_pe writes SAM
byte-identical to map_batch_pe_tpu and to the numpy oracle, each taken to
its SAM v1 form (tests/sam_v1.py: the G->A gapped records and the mate
fields that the JAX package writes otherwise)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bitmapperbs_tpu import constants as K  # noqa: E402
from bitmapperbs_tpu.config import AlignerConfig  # noqa: E402
from bitmapperbs_tpu.index.build import build_index  # noqa: E402
from bitmapperbs_tpu.index.device import upload_index as jupload  # noqa: E402
from bitmapperbs_tpu.models import paired as jpaired  # noqa: E402
from bitmapperbs_tpu.models.host import map_batch_pe_tpu  # noqa: E402
from bitmapperbs_tpu.ops import verify as jv  # noqa: E402
from bitmapperbs_tpu.oracle.paired import map_batch_pe  # noqa: E402
from bitmapperbs_tpu.utils import dna  # noqa: E402
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,  # noqa: E402
                                            repeat_genome_fasta,
                                            simulate_pairs)
from bitmapperbs_tpu_torch.index.device import (  # noqa: E402
    _device_layout_planes, upload_index)
from bitmapperbs_tpu_torch.models import paired as tpaired  # noqa: E402
from bitmapperbs_tpu_torch.models.host import (map_batch_pe as tmap_pe,  # noqa: E402
                                               prepare_batch)
from bitmapperbs_tpu_torch.ops import kernels  # noqa: E402
from bitmapperbs_tpu_torch.ops import verify as tv  # noqa: E402
from chip_smoke import straddling_pairs, tandem_genome_fasta  # noqa: E402
from sam_v1 import sam_v1  # noqa: E402

B = 48


def v1(idx, recs) -> tuple[list[str], int]:
    """The JAX package's PE records as SAM v1 lines, and how many changed."""
    return sam_v1([r.line() for r in recs], idx.genome, paired=True)


def cfg_pe(**kw):
    base = dict(max_errors=4, indels=True, paired=True, min_insert=120,
                max_insert=280, read_len_bucket=96, batch_size=B)
    base.update(kw)
    return AlignerConfig(**base)


def kill_seeds(read, rng):
    """Three substitutions spread over the read: most of its seeds miss,
    so its pair takes the rescue branch."""
    r = read.copy()
    for j in (5, 30, 60):
        r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
    return r


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(23)
    idx = build_index(random_genome_fasta(rng, contigs=(6000, 3000)))
    return idx, jupload(idx), upload_index(idx)


@pytest.fixture(scope="module")
def pair_sets(setup):
    """Named pair lists: `mixed` (ordinary pairs, short mates, and mates 2
    with three seeds killed), `rescue` (every mate 2 killed), `underflow`
    (tests/test_pe_parity.py's window-underflow pairs: an anchor at the
    frame start with the true missing mate planted far away)."""
    idx = setup[0]
    g = np.asarray(idx.genome.codes)
    rng = np.random.default_rng(7)
    sims = simulate_pairs(idx.genome, 40, read_len=80, seed=42,
                          min_insert=150, max_insert=260, sub_rate=0.01,
                          indel_rate=0.01)
    mixed = []
    for i, (s1, s2) in enumerate(sims):
        r1, r2 = s1.codes, s2.codes
        if i % 5 == 1:
            r1, r2 = r1[:int(rng.integers(50, 80))], r2[:64]
        elif i % 5 == 3:
            r2 = kill_seeds(r2, rng)
        mixed.append((r1, r2))
    clean = simulate_pairs(idx.genome, 32, read_len=80, seed=43,
                           min_insert=150, max_insert=260, sub_rate=0.0)
    rescue = [(s1.codes, kill_seeds(s2.codes, rng)) for s1, s2 in clean]
    underflow = [(dna.revcomp(g[0:80]), g[4000:4080].copy()),
                 (g[0:80].copy(), dna.revcomp(g[4000:4080]))]
    return {"mixed": mixed, "rescue": rescue, "underflow": underflow}


# ---- the mate-rescue scan --------------------------------------------------

@pytest.mark.parametrize("m", [32, 64, 96])
def test_myers_scan_matches_jax(rng, m):
    """Seeded lanes over a real two-contig genome: reads cut next to the
    window start with bisulfite conversion, substitutions, indels, N codes
    and short lengths; window starts that wrap below 0 and windows that run
    past the genome end.  ops/verify.myers_scan, the plain scan under
    kernels.rescue_scan_ref, equals the JAX package's."""
    from bitmapperbs_tpu.index.build import parse_fasta

    genome = parse_fasta(random_genome_fasta(rng, contigs=(900, 400)))
    L = genome.length
    gp = _device_layout_planes(genome)
    ref = np.stack([genome.codes, genome.rc_codes()])
    e, R, n = 3, 37, 96
    ncols = R + m + 2 * e
    Ww = -(-ncols // 32)
    orient = rng.integers(0, 2, n)
    starts = rng.integers(0, L - ncols, n).astype(np.int64)
    starts[:10] = -rng.integers(1, e + 1, 10)              # below 0
    starts[10:20] = L - rng.integers(m // 2, ncols, 10)    # past the end
    lens = np.where(rng.random(n) < 0.4, rng.integers(m // 2, m + 1, n), m)
    off = rng.integers(0, R + 1, n)
    reads = np.full((n, m), K.N_CODE, np.uint8)
    for i in range(n):
        pos = starts[i] + e + off[i] + np.arange(lens[i])
        r = ref[orient[i], np.clip(pos, 0, L - 1)].copy()
        r[(pos < 0) | (pos >= L)] = K.N_CODE
        r[(r == K.C) & (rng.random(len(r)) < 0.7)] = K.T
        for _ in range(int(rng.integers(0, e + 2))):
            p = int(rng.integers(0, len(r)))
            op = rng.integers(0, 3)
            if op == 0:
                r[p] = rng.integers(0, 5)
            elif op == 1:
                r = np.delete(r, p)
            else:
                r = np.insert(r, p, rng.integers(0, 4))
        r = r[:lens[i]]
        lens[i] = len(r)
        reads[i, :len(r)] = r
    u32_starts = (starts % (1 << 32)).astype(np.uint32)

    win_t = tv.window_planes(torch.from_numpy(gp.view(np.int32)),
                             torch.from_numpy(orient),
                             torch.from_numpy(u32_starts.astype(np.int64)),
                             Ww, L)
    peq_t, pad_t = tv.build_peq(torch.from_numpy(reads),
                                torch.from_numpy(lens), m)
    win_j = jv.window_planes(jnp.asarray(gp), jnp.asarray(orient),
                             jnp.asarray(u32_starts), Ww, L)
    want = np.asarray(jv.myers_scan(
        win_j, *jv.build_peq(jnp.asarray(reads), jnp.asarray(lens), m), m,
        ncols))
    got = tv.myers_scan(win_t, peq_t, pad_t, m, ncols)
    assert got.dtype == torch.int32 and got.shape == (n, ncols)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want <= e).any() and (want > e).any()
    # the plain min-Myers and the scan share one recurrence
    np.testing.assert_array_equal(
        kernels.myers_ref(win_t, peq_t, pad_t, m, ncols).numpy(),
        np.minimum(want.min(axis=-1), m))


# ---- map_batch_pe_device ---------------------------------------------------

DEVICE_CASES = {
    "scan": ("mixed", cfg_pe()),
    "hamming": ("mixed", cfg_pe(max_errors=3, indels=False)),
    "dense": ("mixed", cfg_pe(compact=False)),
    "gdrop": ("mixed", cfg_pe(locate_flat_cap=1)),
    "pbat": ("mixed", cfg_pe(non_directional=True, min_insert=100,
                             max_insert=450)),
    "rescue": ("rescue", cfg_pe(max_errors=3)),
    "underflow_rev": ("underflow", cfg_pe(max_errors=3, min_insert=200,
                                          max_insert=400)),
    "underflow_fwd": ("underflow", cfg_pe(max_errors=3, min_insert=0,
                                          max_insert=60)),
}


def assert_same_tree(got: dict, want: dict, path=""):
    assert set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            assert_same_tree(got[k], w, f"{path}{k}.")
        else:
            np.testing.assert_array_equal(
                got[k].numpy().astype(np.int64), np.asarray(w).astype(
                    np.int64), err_msg=f"{path}{k}")


@pytest.mark.parametrize("name", sorted(DEVICE_CASES))
def test_map_batch_pe_device_matches_jax(setup, pair_sets, name):
    idx, jd, td = setup
    which, cfg = DEVICE_CASES[name]
    pairs = pair_sets[which]
    a1, l1 = prepare_batch([p[0] for p in pairs], 96, len(pairs))
    a2, l2 = prepare_batch([p[1] for p in pairs], 96, len(pairs))
    want = jpaired.map_batch_pe_device(jd, cfg, jnp.asarray(a1),
                                       jnp.asarray(l1), jnp.asarray(a2),
                                       jnp.asarray(l2))
    got = tpaired.map_batch_pe_device(
        td, cfg, torch.from_numpy(a1), torch.from_numpy(l1),
        torch.from_numpy(a2), torch.from_numpy(l2),
        min_read_len1=int(l1.min()), min_read_len2=int(l2.min()))
    assert_same_tree(got, want)
    pair_valid = got["pair_valid"].numpy()
    resc_valid = got["resc_valid"].numpy()
    if name == "gdrop":             # flat-buffer drops, for the host re-run
        assert got["gdrop"].any()
    elif which == "mixed":
        assert pair_valid.any()
    if name in ("scan", "hamming", "rescue"):
        assert resc_valid.any()      # the rescue pass found missing mates
    if which == "underflow":
        assert not pair_valid.any()


# ---- SAM through the host loop ----------------------------------------------

def _sam_cases(idx):
    """tests/test_pe_parity.py's six cases: (pairs, cfg)."""
    g = np.asarray(idx.genome.codes)
    base = dict(max_errors=3, indels=False, min_insert=120, max_insert=280,
                batch_size=64)
    rng = np.random.default_rng(1)
    rescue = []
    for s1, s2 in simulate_pairs(idx.genome, 25, read_len=80, seed=43,
                                 min_insert=150, max_insert=260,
                                 sub_rate=0.0):
        r2 = s2.codes.copy()
        for j in (5, 30, 60):
            r2[j] = (r2[j] + 1 + rng.integers(0, 3)) % 4
        rescue.append((s1.codes, r2))

    def sim(n, read_len, seed, **kw):
        return [(a.codes, b.codes) for a, b in simulate_pairs(
            idx.genome, n, read_len=read_len, seed=seed, **kw)]

    return {
        "clean": (sim(40, 80, 41, min_insert=150, max_insert=260,
                      sub_rate=0.005), cfg_pe(**base)),
        "indels": (sim(30, 80, 42, min_insert=150, max_insert=260,
                       sub_rate=0.01, indel_rate=0.01),
                   cfg_pe(**{**base, "indels": True, "max_errors": 4})),
        "rescue": (rescue, cfg_pe(**base)),
        "discordant": (sim(20, 70, 44, min_insert=150, max_insert=260,
                           sub_rate=0.0),
                       cfg_pe(**{**base, "min_insert": 0,
                                 "max_insert": 50})),
        "underflow": (
            [(dna.revcomp(g[0:80]), g[4000:4080].copy())],
            cfg_pe(**{**base, "indels": True, "min_insert": 200,
                      "max_insert": 400})),
        "underflow_fwd": (
            [(g[0:80].copy(), dna.revcomp(g[4000:4080]))],
            cfg_pe(**{**base, "indels": True, "min_insert": 0,
                      "max_insert": 60})),
        "non_directional": (
            sim(40, 70, 91, sub_rate=0.01, indel_rate=0.005,
                min_insert=150, max_insert=400),
            cfg_pe(**{**base, "max_errors": 4, "indels": True,
                      "non_directional": True, "batch_size": 40,
                      "min_insert": 100, "max_insert": 450})),
    }


# case: whether its JAX-package records hold any that SAM v1 writes
# otherwise (G->A hits with an indel; mate fields)
SAM_CASES = {"clean": False, "indels": True, "rescue": False,
             "discordant": True, "underflow": True, "underflow_fwd": True,
             "non_directional": True}


@pytest.mark.parametrize("name", SAM_CASES)
def test_map_batch_pe_sam_matches_reference_and_oracle(setup, name):
    idx, jd, td = setup
    pairs, cfg = _sam_cases(idx)[name]
    got = [r.line() for r in tmap_pe(idx, td, cfg, pairs)]
    ref, changed = v1(idx, map_batch_pe_tpu(idx, jd, cfg, pairs))
    orecs = map_batch_pe(idx, cfg, pairs)
    assert got == ref
    assert got == v1(idx, orecs)[0]
    assert (changed > 0) == SAM_CASES[name]
    proper = sum(bool(r.flag & K.FLAG_PROPER) for r in orecs)
    if name == "rescue":
        assert proper >= 40          # most pairs recovered through rescue
    if name.startswith("underflow"):
        assert proper == 0           # no spurious proper pair


def test_map_batch_pe_gdrop_rerun_and_stats(setup, pair_sets):
    """A batch whose flat buffer overflows (locate_flat_cap=1) is re-run
    dense and merged per pair: the SAM equals the dense pipeline's, split
    over two batches (the tail one padded), and the overflow count is the
    reference's."""
    from bitmapperbs_tpu.io.stats import MapStats

    idx, jd, td = setup
    pairs = pair_sets["mixed"]
    cfg = cfg_pe(locate_flat_cap=1, batch_size=32)
    st_t, st_j = MapStats(), MapStats()
    got = [r.line() for r in tmap_pe(idx, td, cfg, pairs, stats=st_t)]
    dense = [r.line() for r in tmap_pe(idx, td, cfg.replace(compact=False),
                                       pairs)]
    ref, changed = v1(idx, map_batch_pe_tpu(idx, jd, cfg, pairs, stats=st_j))
    assert got == dense == ref
    assert changed > 0
    assert len(got) == 2 * len(pairs)
    assert st_t.overflow_reads == st_j.overflow_reads


# ---- the rescue branch deciding: mates inside a repeat ------------------------

@pytest.mark.parametrize("indels", [True, False])
def test_rescue_branch_in_repeats(indels):
    """Pairs with one mate in the tandem repeat and the other in the unique
    flank: the pair join finds nothing, the rescue pass (Myers scan with
    indels, per-offset Hamming without) decides them.  Device tensors equal
    the JAX package's; SAM equals map_batch_pe_tpu's and the oracle's."""
    idx = build_index(tandem_genome_fasta(31))
    jd, td = jupload(idx), upload_index(idx)
    pairs = straddling_pairs(idx, 32, seed=32) + [
        (a.codes, b.codes) for a, b in simulate_pairs(
            idx.genome, 8, read_len=80, seed=5, min_insert=150,
            max_insert=260)]
    cfg = cfg_pe(max_errors=3, indels=indels)
    a1, l1 = prepare_batch([p[0] for p in pairs], 96, len(pairs))
    a2, l2 = prepare_batch([p[1] for p in pairs], 96, len(pairs))
    want = jpaired.map_batch_pe_device(jd, cfg, jnp.asarray(a1),
                                       jnp.asarray(l1), jnp.asarray(a2),
                                       jnp.asarray(l2))
    got = tpaired.map_batch_pe_device(
        td, cfg, torch.from_numpy(a1), torch.from_numpy(l1),
        torch.from_numpy(a2), torch.from_numpy(l2),
        min_read_len1=int(l1.min()), min_read_len2=int(l2.min()))
    assert_same_tree(got, want)
    decided = (got["resc_valid"] & ~got["pair_valid"]).numpy()
    assert decided[:32].sum() >= 16
    sam = [r.line() for r in tmap_pe(idx, td, cfg, pairs)]
    ref, changed = v1(idx, map_batch_pe_tpu(idx, jd, cfg, pairs))
    assert sam == ref
    orecs = map_batch_pe(idx, cfg, pairs)
    assert sam == v1(idx, orecs)[0]
    assert changed == 0
    proper = np.array([bool(r.flag & K.FLAG_PROPER) for r in orecs[::2]])
    assert proper[:len(decided)][decided].all()


# ---- the Gbp-scale configuration on a repeat-structured genome ---------------

GBP = dict(seed_ext_max=20, seed_ext_occ=4, max_candidates=128)
GBP_CASES = {
    "gbp": cfg_pe(**GBP),
    "gbp_chunks": cfg_pe(flat_chunks=2, **GBP),
    "gbp_pbat": cfg_pe(non_directional=True, min_insert=100, max_insert=450,
                       **GBP),
    "gbp_gdrop": cfg_pe(locate_flat_cap=1, **GBP),
}


@pytest.fixture(scope="module")
def repeat_setup():
    """Planted-repeat genome (plant_repeats defaults) and pairs simulated
    over all of it: ordinary pairs, short mates, and mates 2 with three
    seeds killed."""
    idx = build_index(repeat_genome_fasta(np.random.default_rng(79),
                                          contigs=(40000, 20000)))
    rng = np.random.default_rng(8)
    pairs = []
    for i, (s1, s2) in enumerate(simulate_pairs(
            idx.genome, 40, read_len=80, seed=44, min_insert=150,
            max_insert=260, sub_rate=0.01, indel_rate=0.01)):
        r1, r2 = s1.codes, s2.codes
        if i % 5 == 1:
            r1, r2 = r1[:int(rng.integers(50, 80))], r2[:64]
        elif i % 5 == 3:
            r2 = kill_seeds(r2, rng)
        pairs.append((r1, r2))
    return idx, jupload(idx), upload_index(idx), pairs


@pytest.mark.parametrize("name", sorted(GBP_CASES))
def test_gbp_config_pe_device_matches_jax(repeat_setup, name):
    idx, jd, td, pairs = repeat_setup
    cfg = GBP_CASES[name]
    a1, l1 = prepare_batch([p[0] for p in pairs], 96, len(pairs))
    a2, l2 = prepare_batch([p[1] for p in pairs], 96, len(pairs))
    want = jpaired.map_batch_pe_device(jd, cfg, jnp.asarray(a1),
                                       jnp.asarray(l1), jnp.asarray(a2),
                                       jnp.asarray(l2))
    got = tpaired.map_batch_pe_device(
        td, cfg, torch.from_numpy(a1), torch.from_numpy(l1),
        torch.from_numpy(a2), torch.from_numpy(l2),
        min_read_len1=int(l1.min()), min_read_len2=int(l2.min()))
    assert_same_tree(got, want)
    if name == "gbp_gdrop":
        assert got["gdrop"].any()
    else:
        assert got["pair_valid"].numpy().sum() > len(pairs) // 2


@pytest.mark.parametrize("name", sorted(GBP_CASES))
def test_gbp_config_pe_sam_matches_reference_and_oracle(repeat_setup, name):
    idx, jd, td, pairs = repeat_setup
    cfg = GBP_CASES[name]
    got = [r.line() for r in tmap_pe(idx, td, cfg, pairs)]
    ref, changed = v1(idx, map_batch_pe_tpu(idx, jd, cfg, pairs))
    assert got == ref
    assert got == v1(idx, map_batch_pe(idx, cfg, pairs))[0]
    assert changed > 0
