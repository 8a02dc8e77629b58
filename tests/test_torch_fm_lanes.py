"""PyTorch port: the FM-index step kernels' control flow, as scalar per-lane
models.

The CUDA kernels of csrc/fm.cu cannot run without a card, so their control
flow is written out here lane by lane in plain Python (own loop, early exit,
u32 arithmetic with & 0xFFFFFFFF, the table clamps, the split of a checkpoint
row over two cooperating threads) and held exactly equal to the
lockstep plain versions the wrappers run on CPU tensors and to the JAX
functions, on lanes that include the edge cases named in each test."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bitmapperbs_tpu.index.build import build_index  # noqa: E402
from bitmapperbs_tpu.index.device import upload_index  # noqa: E402
from bitmapperbs_tpu.ops import fm as jfm  # noqa: E402
from bitmapperbs_tpu.utils import dna  # noqa: E402
from bitmapperbs_tpu.utils.simulate import random_genome_fasta  # noqa: E402
from bitmapperbs_tpu_torch import constants as K  # noqa: E402
from bitmapperbs_tpu_torch.index import device as tdev  # noqa: E402
from bitmapperbs_tpu_torch.ops import fm as tfm  # noqa: E402
from bitmapperbs_tpu_torch.ops import kernels  # noqa: E402

M = 64
U32 = 0xFFFFFFFF
TPR = 2                     # threads that share a checkpoint row (kTpr)


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
    assert td.klt_k > 0 and td.sa_rate > 1
    return idx, jd, td


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=msg)


# ---- the scalar models (one lane at a time, as a thread group runs it) -----

class Tables:
    """The index tables as the kernels see them: u32 words and int64s."""

    def __init__(self, td):
        self.cp = td.cp_rows.numpy().view(np.uint32).astype(np.int64)
        self.sa = td.sa_samples.numpy().view(np.uint32).astype(np.int64)
        self.cbase = td.cbase.numpy()
        self.n = td.n.numpy()
        self.rows_max, self.samples_max = td.rows_max, td.samples_max
        self.sa_rate = td.sa_rate


def lower_mask(within, w):
    nb = within - 32 * w
    return 0 if nb <= 0 else (U32 if nb >= 32 else (1 << nb) - 1)


def cp_row(ix, blk, i):
    r = i // K.CP_BLOCK + blk * ix.rows_max
    return ix.cp[min(max(r, 0), len(ix.cp) - 1)]


def popc(x):
    return bin(x).count("1")


def occ_model(ix, blk, c, i):
    """occ(c, i) as TPR threads count it: thread j takes the count word (j
    == 0) and plane words j, j + TPR, ...; the shares are summed."""
    row, within = cp_row(ix, blk, i), i % K.CP_BLOCK
    b0, b1 = (0 - (c & 1)) & U32, (0 - ((c >> 1) & 1)) & U32
    total = 0
    for j in range(TPR):
        acc = int(row[c]) if j == 0 else 0
        for k in range(K.CP_WORDS // TPR):
            w = j + k * TPR
            ind = (~(int(row[4 + w]) ^ b0)) & (~(int(row[8 + w]) ^ b1)) & U32
            acc = (acc + popc(ind & lower_mask(within, w))) & U32
        total = (total + acc) & U32
    return total


def backward_model(ix, blk, c, sp, ep):
    cb = int(ix.cbase[blk, c])
    return ((cb + occ_model(ix, blk, c, sp)) & U32,
            (cb + occ_model(ix, blk, c, ep)) & U32)


def search_model(ix, blk, pat, start, end, sp0, ep0, k, max_len):
    length = end - start
    if k == 0 or length < k:
        sp, ep, t = 0, int(ix.n[blk]) & U32, 0
    else:
        sp, ep, t = sp0, ep0, k
    stop = min(length, max_len)
    while t < stop and ep > sp:
        q = min(max(end - 1 - t, 0), len(pat) - 1)
        sp, ep = backward_model(ix, blk, int(pat[q]) & 3, sp, ep)
        t += 1
    return sp, ep


def extend_model(ix, blk, pat, st, sp, ep, ext_max, ext_occ):
    """Returns (sp, ep, starts, why): why the lane's loop ended."""
    for _ in range(ext_max):
        if not ((ep - sp) & U32) > ext_occ:
            return sp, ep, st, "rare"
        if not st > 0:
            return sp, ep, st, "read start"
        q = min(max(st - 1, 0), len(pat) - 1)
        nsp, nep = backward_model(ix, blk, int(pat[q]) & 3, sp, ep)
        if nep <= nsp:
            return sp, ep, st, "dead"
        sp, ep, st = nsp, nep, st - 1
    return sp, ep, st, "ext_max"


def locate_model(ix, blk, i, valid):
    """Returns (position, steps taken, whether a mark was found)."""
    last = (int(ix.n[blk]) - 1) & U32
    cur = min(i & U32 if valid else 0, last)
    steps = rank = 0
    found = False
    for _ in range(ix.sa_rate):
        row, within = cp_row(ix, blk, cur), cur % K.CP_BLOCK
        wsel, b = within >> 5, within & 31
        mrank, flags = 0, 0
        for j in range(TPR):                       # each thread's share
            share = int(row[K.CP_MARK_OFF]) if j == 0 else 0
            for k in range(K.CP_WORDS // TPR):
                w = j + k * TPR
                mk = int(row[K.CP_MARK_OFF + 1 + w])
                share = (share + popc(mk & lower_mask(within, w))) & U32
                if w == wsel:
                    flags += ((mk >> b) & 1) \
                        | (((int(row[4 + w]) >> b) & 1) << 1) \
                        | (((int(row[8 + w]) >> b) & 1) << 2)
            mrank = (mrank + share) & U32
        if flags & 1:
            rank, found = mrank, True
            break
        c = ((flags >> 1) & 1) | (((flags >> 2) & 1) << 1)
        nxt = (int(ix.cbase[blk, c]) + occ_model(ix, blk, c, cur)) & U32
        cur = min(nxt, last)
        steps += 1
    si = min(max(blk * ix.samples_max + rank, 0), len(ix.sa) - 1)
    return (int(ix.sa[si]) + steps) & U32, steps, found


# ---- lanes --------------------------------------------------------------------

@pytest.fixture(scope="module")
def seeds(setup):
    """Seed slices of genome patterns in both blocks: a third mutated so
    intervals empty mid-seed, lengths from 2 (shorter than klt_k) to 25,
    some starting at the read start, some of length 0."""
    idx, _, td = setup
    rng = np.random.default_rng(18)
    conv = dna.ct_convert(idx.genome.codes)
    n = 320
    pats = np.stack([conv[p:p + M] for p in rng.integers(300, 3500, n)])
    pats[::3, 38:44] = rng.integers(1, 4, (len(pats[::3]), 6))
    starts = rng.integers(0, M - 26, n)
    starts[::7] = 0
    ends = starts + rng.integers(2, 26, n)
    ends[5::41] = starts[5::41]                        # empty slices
    blocks = rng.integers(0, 2, n)
    lens = ends - starts
    assert (lens < td.klt_k).any() and (lens > td.klt_k).any()
    assert set(blocks) == {0, 1}
    return pats.astype(np.uint8), starts, ends, blocks


def _end_kmers(td, pats, ends):
    km = tfm.rolling_kmers(torch.from_numpy(pats), td.klt_k)
    return km[torch.arange(len(ends)), (T(ends) - 1).clamp(0, M - 1)]


@pytest.mark.parametrize("klt", [False, True])
def test_search_lane_model(setup, seeds, klt):
    """Own loop from (sp0, ep0, t0), exit on an empty interval or at the
    slice's length: equal to the lockstep version and to the JAX search, on
    lanes with intervals that empty mid-seed, slices shorter than klt_k
    (which walk from (0, n)), empty slices, both blocks."""
    _, jd, td = setup
    pats, starts, ends, blocks = seeds
    ix = Tables(td)
    max_len = 26
    ek = _end_kmers(td, pats, ends) if klt else None
    k = td.klt_k if klt else 0
    sp0 = ep0 = None
    if klt:
        sp0, ep0 = tfm.klt_lookup(td, T(blocks), ek)
    model = np.array([
        search_model(ix, int(blocks[i]), pats[i], int(starts[i]),
                     int(ends[i]), int(sp0[i]) if klt else 0,
                     int(ep0[i]) if klt else 0, k, max_len)
        for i in range(len(starts))])
    plain = tfm.search_lockstep(td, T(blocks), torch.from_numpy(pats),
                                T(starts), T(ends), sp0, ep0, k, max_len)
    wrapped = kernels.fm_search(td, T(blocks), torch.from_numpy(pats),
                                T(starts), T(ends), sp0, ep0, k, max_len)
    want = jfm.search_patterns(
        jd, jnp.asarray(blocks, dtype=jnp.int32), jnp.asarray(pats),
        jnp.asarray(starts, dtype=jnp.int32),
        jnp.asarray(ends, dtype=jnp.int32), max_len=max_len,
        end_kmers=jnp.asarray(ek.numpy().astype(np.int32)) if klt else None)
    for col in (0, 1):
        same(model[:, col], want[col], "model vs JAX")
        same(plain[col], want[col], "lockstep vs JAX")
        same(wrapped[col], want[col], "wrapper vs JAX")
    emptied = model[:, 1] <= model[:, 0]
    assert emptied.any() and (~emptied).any()


def test_extend_lane_model(setup, seeds):
    """The loop ends at the first step not taken.  Lanes: heavy short seeds
    that extend, seeds already rare at step 0, seeds at the read start
    (starts == 0), seeds that die because the next character would empty
    them, seeds that use all ext_max steps; both blocks."""
    _, jd, td = setup
    pats, starts, ends, blocks = seeds
    ix = Tables(td)
    pats = pats.copy()
    pats[1::5, :12] = 3                                # long T runs: heavy
    starts = starts.copy()
    starts[1::5] = 14
    ends = np.minimum(ends, starts + 5)
    ends[::2] = np.minimum(ends[::2], starts[::2] + 3)     # very heavy
    ends[1::5] = starts[1::5] + 2
    ext_max, ext_occ = 12, 2
    sp_j, ep_j = jfm.search_patterns(
        jd, jnp.asarray(blocks, dtype=jnp.int32), jnp.asarray(pats),
        jnp.asarray(starts, dtype=jnp.int32),
        jnp.asarray(ends, dtype=jnp.int32), max_len=6)
    sp0, ep0 = np.asarray(sp_j).astype(np.int64), \
        np.asarray(ep_j).astype(np.int64)
    rows = [extend_model(ix, int(blocks[i]), pats[i], int(starts[i]),
                         int(sp0[i]), int(ep0[i]), ext_max, ext_occ)
            for i in range(len(starts))]
    why = [r[3] for r in rows]
    for reason in ("rare", "read start", "dead", "ext_max"):
        assert reason in why, f"no lane ended by: {reason}"
    at_step0 = [r for r, s in zip(rows, starts) if r[2] == s]
    assert any(r[3] == "rare" for r in at_step0)      # ext_occ met at step 0
    assert any(r[2] < s for r, s in zip(rows, starts))    # and lanes that moved
    model = np.array([r[:3] for r in rows])
    args = (td, T(blocks), torch.from_numpy(pats), T(starts), T(sp0), T(ep0),
            ext_max, ext_occ)
    plain = tfm.extend_lockstep(*args)
    wrapped = kernels.fm_extend(*args)
    want = jfm.extend_seeds(jd, jnp.asarray(blocks, dtype=jnp.int32),
                            jnp.asarray(pats),
                            jnp.asarray(starts, dtype=jnp.int32), sp_j, ep_j,
                            ext_max, ext_occ)
    for col in range(3):
        same(model[:, col], want[col], "model vs JAX")
        same(plain[col], want[col], "lockstep vs JAX")
        same(wrapped[col], want[col], "wrapper vs JAX")


def test_locate_lane_model(setup):
    """Exit at the first marked position, sample + steps as u32.  Lanes:
    every walk length 0..sa_rate-1, invalid lanes (they walk from 0), i at
    and past n (clamped to n - 1), i = 0xFFFFFFFF, both blocks."""
    idx, jd, td = setup
    ix = Tables(td)
    rng = np.random.default_rng(23)
    n = 400
    block = rng.integers(0, 2, n)
    i = np.array([rng.integers(0, idx.blocks[b].n) for b in block])
    past = slice(0, 40)
    i[past] = np.array([idx.blocks[b].n for b in block[past]]) \
        + rng.integers(0, 5000, 40)
    i[40:44] = U32
    valid = rng.random(n) < 0.85
    valid[:20] = True
    rows = [locate_model(ix, int(block[a]), int(i[a]), bool(valid[a]))
            for a in range(n)]
    assert {r[1] for r in rows if r[2]} == set(range(td.sa_rate))
    assert (~valid).any() and set(block) == {0, 1}
    args = (td, T(block), T(i), torch.from_numpy(valid))
    want = jfm.locate(jd, jnp.asarray(block, dtype=jnp.int32),
                      jnp.asarray(i.astype(np.uint32)), jnp.asarray(valid))
    same([r[0] for r in rows], want, "model vs JAX")
    same(tfm.locate_lockstep(*args), want, "lockstep vs JAX")
    same(kernels.fm_locate(*args), want, "wrapper vs JAX")


def test_broadcast_patterns_are_not_copied(setup, seeds):
    """The aligner's lanes: patterns [B, F, m] expanded over S seeds.  The
    kernel wrapper addresses rows through the strides; the plain path gives
    the per-lane result of the materialised patterns."""
    _, _, td = setup
    pats, starts, ends, blocks = seeds
    B, F, S = 4, 2, 5
    p3 = torch.from_numpy(pats[:B * F].reshape(B, F, M))
    pat_l = p3[:, :, None, :].expand(B, F, S, M)
    st = T(starts[:B * F * S].reshape(B, F, S))
    en = T(ends[:B * F * S].reshape(B, F, S))
    blk = T(blocks[:F])[None, :, None].expand(B, F, S)
    view, args = kernels._pattern_args(pat_l, (B, F, S))
    assert view.data_ptr() == p3.data_ptr()
    assert args[1:] == [F, S, F * M, M, 0, M]
    got = kernels.fm_search(td, blk, pat_l, st, en, None, None, 0, 26)
    flat = kernels.fm_search(td, blk.reshape(-1),
                             pat_l.reshape(-1, M).contiguous(),
                             st.reshape(-1), en.reshape(-1), None, None, 0, 26)
    for g, f in zip(got, flat):
        assert g.shape == (B, F, S)
        same(g.reshape(-1), f)


# ---- the wrappers on the CPU ---------------------------------------------------

def _lane_args(td, seeds):
    pats, starts, ends, blocks = seeds
    return (td, T(blocks), torch.from_numpy(pats), T(starts), T(ends))


@pytest.mark.parametrize("which", ["fm_search", "fm_extend", "fm_locate"])
def test_fm_wrappers_count_no_launch_and_raise(setup, seeds, which):
    """On CPU tensors the wrappers run the plain versions and count no
    launch; a device mix or a wrong lane type raises instead of taking
    another path."""
    _, _, td = setup
    d, blk, pat, st, en = _lane_args(td, seeds)
    before = dict(kernels.LAUNCHES)
    valid = torch.ones(len(st), dtype=torch.bool)
    calls = {
        "fm_search": lambda b, s: kernels.fm_search(d, b, pat, s, en, None,
                                                    None, 0, 8),
        "fm_extend": lambda b, s: kernels.fm_extend(d, b, pat, s, st, en, 4,
                                                    2),
        "fm_locate": lambda b, s: kernels.fm_locate(d, b, s, valid),
    }
    call = calls[which]
    call(blk, st)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError):
        call(blk.to("meta"), st)                      # mixed devices
    with pytest.raises(ValueError):
        call(blk, st.to(torch.int32))                 # wrong lane type
    with pytest.raises(ValueError):
        call(blk.to(torch.int32), st)
    if which == "fm_locate":
        with pytest.raises(ValueError):
            kernels.fm_locate(d, blk, st, valid.to(torch.uint8))
    else:
        with pytest.raises(ValueError):
            kernels.fm_search(d, blk, pat.to(torch.int64), st, en, None, None,
                              0, 8) if which == "fm_search" else \
                kernels.fm_extend(d, blk, pat.to(torch.int64), st, st, en, 4,
                                  2)
    assert kernels.LAUNCHES == before
