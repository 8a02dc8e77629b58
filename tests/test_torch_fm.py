"""PyTorch port: FM-index lane ops equal the JAX reference (ops/fm.py) on one
toy index, lane for lane."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bitmapperbs_tpu import constants as K  # noqa: E402
from bitmapperbs_tpu.index.build import build_index  # noqa: E402
from bitmapperbs_tpu.index.device import upload_index  # noqa: E402
from bitmapperbs_tpu.ops import fm as jfm  # noqa: E402
from bitmapperbs_tpu.utils import dna  # noqa: E402
from bitmapperbs_tpu.utils.simulate import random_genome_fasta  # noqa: E402
from bitmapperbs_tpu_torch.index import device as tdev  # noqa: E402
from bitmapperbs_tpu_torch.ops import fm as tfm  # noqa: E402
from bitmapperbs_tpu_torch.ops import kernels  # noqa: E402

M = 64


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    idx = build_index(random_genome_fasta(rng, contigs=(3000, 1000)))
    jd = upload_index(idx)
    fields = ("cp_rows", "cbase", "sa_samples", "n", "g_planes", "klt")
    static = ("rows_max", "genome_len", "samples_max", "sa_rate", "klt_k",
              "g_words")
    td = tdev.from_arrays({f: np.asarray(getattr(jd, f)) for f in fields},
                          **{s: getattr(jd, s) for s in static})
    assert td.klt_k > 0
    return idx, jd, td


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=msg)


@pytest.fixture(scope="module")
def seeds(setup):
    """Seed slices of genome patterns (some mutated so intervals empty
    mid-seed), lengths straddling klt_k, in both blocks."""
    idx, jd, _ = setup
    rng = np.random.default_rng(8)
    conv = dna.ct_convert(idx.genome.codes)
    n = 96
    pats = np.stack([conv[p:p + M] for p in rng.integers(300, 3500, n)])
    pats[::3, 40:43] = rng.integers(1, 4, (len(pats[::3]), 3))
    starts = rng.integers(0, M - 26, n).astype(np.int32)
    ends = starts + rng.integers(2, 26, n).astype(np.int32)
    blocks = rng.integers(0, 2, n).astype(np.int32)
    return pats.astype(np.uint8), starts, ends, blocks


def test_occ(setup, rng):
    idx, jd, td = setup
    n = 600
    block = rng.integers(0, 2, n).astype(np.int32)
    c = rng.integers(0, K.CONV_ALPHA, n).astype(np.uint32)
    i = np.array([rng.integers(0, idx.blocks[b].n + 1) for b in block],
                 dtype=np.uint32)
    same(tfm.occ(td, T(block), T(c), T(i)),
         jfm.occ(jd, jnp.asarray(block), jnp.asarray(c), jnp.asarray(i)))


def test_locate(setup, rng):
    idx, jd, td = setup
    n = 600
    block = rng.integers(0, 2, n).astype(np.int32)
    i = np.array([rng.integers(0, idx.blocks[b].n) for b in block],
                 dtype=np.uint32)
    valid = rng.random(n) < 0.9
    same(tfm.locate(td, T(block), T(i), torch.from_numpy(valid)),
         jfm.locate(jd, jnp.asarray(block), jnp.asarray(i),
                    jnp.asarray(valid)))


def test_rolling_kmers_and_klt_lookup(setup, seeds):
    _, jd, td = setup
    pats, _, ends, blocks = seeds
    km_t = tfm.rolling_kmers(torch.from_numpy(pats), td.klt_k)
    km_j = jfm.rolling_kmers(jnp.asarray(pats), jd.klt_k)
    same(km_t, km_j)
    ek = km_t[torch.arange(len(ends)), T(ends) - 1]
    for g, w in zip(tfm.klt_lookup(td, T(blocks), ek),
                    jfm.klt_lookup(jd, jnp.asarray(blocks),
                                   jnp.asarray(ek.numpy().astype(np.int32)))):
        same(g, w)


@pytest.mark.parametrize("klt", [False, True])
def test_search_patterns(setup, seeds, klt):
    """Plain and KLT-started search, including lanes shorter than klt_k."""
    _, jd, td = setup
    pats, starts, ends, blocks = seeds
    lens = ends - starts
    assert (lens < td.klt_k).any() and (lens > td.klt_k).any()
    ek_t = ek_j = None
    if klt:
        km = tfm.rolling_kmers(torch.from_numpy(pats), td.klt_k)
        ek_t = km[torch.arange(len(ends)), T(ends) - 1]
        ek_j = jnp.asarray(ek_t.numpy().astype(np.int32))
    got = tfm.search_patterns(td, T(blocks), torch.from_numpy(pats),
                              T(starts), T(ends), max_len=26, end_kmers=ek_t)
    want = jfm.search_patterns(jd, jnp.asarray(blocks), jnp.asarray(pats),
                               jnp.asarray(starts), jnp.asarray(ends),
                               max_len=26, end_kmers=ek_j)
    for g, w in zip(got, want):
        same(g, w)


def test_search_patterns_skips_short_phase(setup, seeds):
    """With every slice at least klt_k long and min_len saying so, the
    short-lane phase is skipped and the result still equals the
    reference's."""
    _, jd, td = setup
    pats, starts, ends, blocks = seeds
    keep = ends - starts >= td.klt_k
    pats, starts, ends, blocks = (a[keep] for a in (pats, starts, ends,
                                                    blocks))
    assert len(starts) > 10
    km = tfm.rolling_kmers(torch.from_numpy(pats), td.klt_k)
    ek_t = km[torch.arange(len(ends)), T(ends) - 1]
    got = tfm.search_patterns(td, T(blocks), torch.from_numpy(pats),
                              T(starts), T(ends), max_len=26, end_kmers=ek_t,
                              min_len=int((ends - starts).min()))
    want = jfm.search_patterns(jd, jnp.asarray(blocks), jnp.asarray(pats),
                               jnp.asarray(starts), jnp.asarray(ends),
                               max_len=26,
                               end_kmers=jnp.asarray(
                                   ek_t.numpy().astype(np.int32)))
    for g, w in zip(got, want):
        same(g, w)


def test_extend_seeds(setup, seeds):
    _, jd, td = setup
    pats, starts, ends, blocks = seeds
    ends = np.minimum(ends, starts + 6).astype(np.int32)  # heavy short seeds
    sp_j, ep_j = jfm.search_patterns(jd, jnp.asarray(blocks),
                                     jnp.asarray(pats), jnp.asarray(starts),
                                     jnp.asarray(ends), max_len=6)
    assert (np.asarray(ep_j) - np.asarray(sp_j) > 2).any()
    got = tfm.extend_seeds(td, T(blocks), torch.from_numpy(pats), T(starts),
                           T(np.asarray(sp_j)), T(np.asarray(ep_j)), 12, 2)
    want = jfm.extend_seeds(jd, jnp.asarray(blocks), jnp.asarray(pats),
                            jnp.asarray(starts), sp_j, ep_j, 12, 2)
    for g, w in zip(got, want):
        same(g, w)


# ---- the table row gather ------------------------------------------------------

@pytest.mark.parametrize("W", [1, 2, 3, 17, 5])
def test_gather_rows_matches_jax_indexing(W):
    """gather_rows on CPU tensors (its plain version; no launch) equals the
    JAX gather table[idx] for every row width the mapping path uses and one
    it does not, over lane shapes of 1-3 dimensions; indices at and past
    the table end clamp to the last row as the JAX gather clamps them, and
    negative ones to row 0."""
    rng = np.random.default_rng(40 + W)
    R = 257
    table = rng.integers(0, 1 << 32, (R, W), dtype=np.uint64).astype(
        np.uint32)
    tt = torch.from_numpy(table.view(np.int32))
    before = dict(kernels.LAUNCHES)
    for shape in ((301,), (7, 5), (3, 4, 6)):
        idx = rng.integers(0, R, shape)
        idx.reshape(-1)[::7] = R + rng.integers(0, 1000, idx.size)[::7]
        idx.reshape(-1)[0] = R
        want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
        got = kernels.gather_rows(tt, torch.from_numpy(idx))
        assert got.dtype == torch.int32 and got.shape == (*shape, W)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(want.reshape(-1, W)[0], table[R - 1])
        neg = torch.from_numpy(-1 - idx)
        assert torch.equal(kernels.gather_rows(tt, neg),
                           tt[0].expand(*shape, W))
    assert kernels.LAUNCHES == before                     # no kernel ran
    with pytest.raises(ValueError):                       # no silent path
        kernels.gather_rows(tt.to("meta"), torch.zeros(4, dtype=torch.int64))


def test_fetchers_clamp_like_the_reference(setup):
    """fetch_cp_rows / fetch_sa_samples / klt_lookup go through gather_rows:
    rows past either table end read the last row, as the reference's."""
    _, jd, td = setup
    rows = np.array([0, 5, td.cp_rows.shape[0] - 1, td.cp_rows.shape[0] + 9])
    same(tfm.fetch_cp_rows(td, T(rows)),
         jfm.fetch_cp_rows(jd, jnp.asarray(rows, dtype=jnp.int32)))
    flat = np.array([0, 3, 2 * td.samples_max - 1, 2 * td.samples_max + 4])
    same(tfm.fetch_sa_samples(td, T(flat)),
         jfm.fetch_sa_samples(jd, jnp.asarray(flat, dtype=jnp.int32)))
    # an expanded (stride-0) index tensor is made contiguous on the way in
    blk = torch.tensor([0, 1])[:, None].expand(2, 3)
    km = torch.tensor([[0, 7, 3 ** td.klt_k - 1]]).expand(2, 3)
    sp, ep = tfm.klt_lookup(td, blk, km)
    jsp, jep = jfm.klt_lookup(jd, jnp.asarray(blk.numpy(), dtype=jnp.int32),
                              jnp.asarray(km.numpy(), dtype=jnp.int32))
    same(sp, jsp)
    same(ep, jep)
