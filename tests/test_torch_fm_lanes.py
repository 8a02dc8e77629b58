"""PyTorch port: the FM-index step kernels' control flow, as scalar per-lane
models.

The CUDA kernels of csrc/fm.cu cannot run without a card, so their control
flow is written out here lane by lane in plain Python (own loop, early exit,
u32 arithmetic with & 0xFFFFFFFF, the table clamps, the split of a checkpoint
row over two cooperating threads) and held exactly equal to the
lockstep plain versions the wrappers run on CPU tensors and to the JAX
functions, on lanes that include the edge cases named in each test.  The
kernels' SHARD instances (a sharded index: the row fetch picks the shard that
holds the row, a zero row past the table) are modelled the same way and held
to the plain versions on a sharded index of 2 and 3 CPU devices and to the
JAX package's sharded functions under shard_map."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from bitmapperbs_tpu.index.build import build_index  # noqa: E402
from bitmapperbs_tpu.index.device import upload_index  # noqa: E402
from bitmapperbs_tpu.ops import fm as jfm  # noqa: E402
from bitmapperbs_tpu.parallel.shard import _dix_specs  # noqa: E402
from bitmapperbs_tpu.parallel.shard import \
    upload_index_sharded as jupload_sharded  # noqa: E402
from bitmapperbs_tpu.utils import dna  # noqa: E402
from bitmapperbs_tpu.utils.simulate import random_genome_fasta  # noqa: E402
from bitmapperbs_tpu_torch import constants as K  # noqa: E402
from bitmapperbs_tpu_torch.index import device as tdev  # noqa: E402
from bitmapperbs_tpu_torch.ops import fm as tfm  # noqa: E402
from bitmapperbs_tpu_torch.ops import kernels  # noqa: E402
from test_torch_rescue_scan import shard_row_model  # noqa: E402

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

def u32_rows(t):
    return t.numpy().view(np.uint32).astype(np.int64)


class Tables:
    """The index tables as the kernels see them: u32 words and int64s.  A
    whole index (SHARD false): rows and SA samples clamped into their
    tables.  A sharded one (SHARD true, csrc/shards.cuh): the part that
    holds the row, a zero row outside every part."""

    def __init__(self, td):
        self.shard = td.sharded
        if self.shard:
            self.cp = [u32_rows(p) for p in td.cp_rows.parts]
            self.sa = [u32_rows(p) for p in td.sa_samples.parts]
        else:
            self.cp = u32_rows(td.cp_rows)
            self.sa = u32_rows(td.sa_samples)
        self.cbase = td.cbase.numpy()
        self.n = td.n.numpy()
        self.rows_max, self.samples_max = td.rows_max, td.samples_max
        self.sa_rate = td.sa_rate

    @staticmethod
    def shard_row(parts, r):
        """shard_row<W>: the part whose first row r reaches last (compares,
        no division), the zero row outside [0, n * rows)."""
        row = shard_row_model(parts, r)
        return np.zeros_like(parts[0][0]) if row is None else row

    def row(self, r):
        """The checkpoint row at flat row r (csrc/fm.cu cp_row)."""
        if self.shard:
            return self.shard_row(self.cp, r)
        return self.cp[min(max(r, 0), len(self.cp) - 1)]

    def sample(self, si):
        """The SA sample at flat index si (csrc/fm.cu sa_sample)."""
        if self.shard:
            return int(self.shard_row(self.sa, min(si,
                                                   2 * self.samples_max - 1)))
        return int(self.sa[min(max(si, 0), len(self.sa) - 1)])


def lower_mask(within, w):
    nb = within - 32 * w
    return 0 if nb <= 0 else (U32 if nb >= 32 else (1 << nb) - 1)


def cp_row(ix, blk, i):
    return ix.row(i // K.CP_BLOCK + blk * ix.rows_max)


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
    return (ix.sample(blk * ix.samples_max + rank) + steps) & U32, steps, found


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


# ---- the SHARD instances: a sharded index ----------------------------------

@pytest.fixture(scope="module")
def sharded(setup):
    """The index split over 2 and 3 devices: the port's on CPU devices, the
    JAX package's on a 1-D 'idx' mesh, with a runner of JAX functions under
    shard_map (lanes replicated, the partial rows psummed)."""
    idx = setup[0]
    out = {}
    for ns in (2, 3):
        td = tdev.upload_index_sharded(idx, [torch.device("cpu")] * ns)
        mesh = JMesh(np.array(jax.devices()[:ns]), ("idx",))
        jd = jupload_sharded(idx, mesh, "idx")

        def run(fn, *lanes, jd=jd, mesh=mesh):
            f = shard_map(fn, mesh=mesh,
                          in_specs=(_dix_specs(jd, "idx"),)
                          + (P(),) * len(lanes),
                          out_specs=P(), check_vma=False)
            return jax.jit(f)(jd, *lanes)
        out[ns] = td, run
    return out


@pytest.mark.parametrize("ns", [2, 3])
def test_shard_fetch_model(setup, sharded, ns):
    """cp_row and the SA-sample load of the SHARD instances: the row of the
    part that holds it on both sides of every shard boundary and in the
    per-block padding, a zero row past the table; SA indices clamped below
    2 * samples_max first.  Equal to ops/fm's fetches on the sharded index
    (what the plain versions read) and to the JAX package's sharded fetch;
    the rows, put end to end, are the whole index's."""
    _, _, whole = setup
    td, run = sharded[ns]
    ix = Tables(td)
    rng = np.random.default_rng(40 + ns)
    rows = td.cp_rows.rows
    total = rows * ns
    assert td.rows_max % ns == 0 and total == 2 * td.rows_max
    pad = [whole.rows_max, td.rows_max - 1, td.rows_max + whole.rows_max,
           total - 1]                              # per-block padding rows
    past = [total, total + 1, total + 12_345, 1 << 30]
    r = np.concatenate([[b + d for b in range(rows, total, rows)
                         for d in (-1, 0)], [0], pad, past,
                        rng.integers(0, total, 200)]).astype(np.int64)
    model = np.stack([ix.row(int(x)) for x in r])
    assert not model[-200 - len(past):-200].any()          # zero past it
    same(tfm.fetch_cp_rows(td, T(r)), model, "plain vs model")
    same(run(jfm.fetch_cp_rows, jnp.asarray(r, jnp.int32)), model,
         "JAX sharded fetch vs model")
    # block 1 starts at the padded stride: row r of block 1 there is row
    # r of block 1 in the whole index
    b1 = rng.integers(0, whole.rows_max, 50)
    same(tfm.fetch_cp_rows(td, T(b1 + td.rows_max)),
         tfm.fetch_cp_rows(whole, T(b1 + whole.rows_max)), "block 1")
    srows = td.sa_samples.rows
    si = np.concatenate([[b + d for b in range(srows, srows * ns, srows)
                          for d in (-1, 0)],
                         [0, whole.samples_max, td.samples_max - 1,
                          2 * td.samples_max - 1, 2 * td.samples_max,
                          2 * td.samples_max + 99],
                         rng.integers(0, 2 * td.samples_max, 200)])
    model = np.array([ix.sample(int(x)) for x in si])
    same(tfm.fetch_sa_samples(td, T(si)), model, "plain SA vs model")
    same(run(jfm.fetch_sa_samples, jnp.asarray(si, jnp.int32)), model,
         "JAX sharded SA fetch vs model")


def _planted_extend_lanes(td, seeds):
    """extend_seeds' lanes with intervals past the table planted: the rows
    of sp or ep lie past every shard (a zero row), in the per-block
    padding, or both."""
    pats, starts, ends, blocks = seeds
    n = len(starts)
    rng = np.random.default_rng(77)
    sp = rng.integers(0, 3000, n)
    ep = sp + rng.integers(1, 400, n)
    top = 2 * td.rows_max * K.CP_BLOCK
    sp[:8] = rng.integers(0, 3000, 8)
    ep[:8] = U32 - rng.integers(0, 1000, 8)                # ep past it
    sp[8:16] = top + rng.integers(0, 5000, 8)              # both past it
    ep[8:16] = sp[8:16] + 500
    pad = td.rows_max * K.CP_BLOCK - rng.integers(1, 64, 8)
    sp[16:24], ep[16:24] = pad - 200, pad                  # block-0 padding
    blocks = blocks.copy()
    blocks[16:24] = 0
    starts = np.maximum(starts, 6)
    return pats, starts, blocks, sp, ep


@pytest.mark.parametrize("ns", [2, 3])
@pytest.mark.parametrize("which", ["search", "extend", "locate"])
def test_shard_lane_models(setup, seeds, sharded, ns, which):
    """fm_search / fm_extend / fm_locate on a sharded index: the scalar
    model with the SHARD fetch equals the wrapper (on CPU tensors: the
    lockstep loop reading the shard set through gather_table) and the JAX
    package's function under shard_map, lane for lane, on the edge lanes of
    the whole-index tests and, for extend, intervals whose rows lie past the
    table, where the zero row gives another result than a clamp would."""
    idx, _, whole = setup
    td, run = sharded[ns]
    ix = Tables(td)
    pats, starts, ends, blocks = seeds
    bj = jnp.asarray(blocks, dtype=jnp.int32)
    if which == "search":
        ek = _end_kmers(td, pats, ends)
        sp0, ep0 = tfm.klt_lookup(td, T(blocks), ek)
        model = np.array([
            search_model(ix, int(blocks[i]), pats[i], int(starts[i]),
                         int(ends[i]), int(sp0[i]), int(ep0[i]), td.klt_k, 26)
            for i in range(len(starts))]).T
        got = kernels.fm_search(td, T(blocks), torch.from_numpy(pats),
                                T(starts), T(ends), sp0, ep0, td.klt_k, 26)
        want = run(lambda d, *a: jfm.search_patterns(
            d, *a, max_len=26, end_kmers=jnp.asarray(ek.numpy(), jnp.int32)),
            bj, jnp.asarray(pats), jnp.asarray(starts, jnp.int32),
            jnp.asarray(ends, jnp.int32))
    elif which == "extend":
        pats, starts, blocks, sp, ep = _planted_extend_lanes(td, seeds)
        rows = [extend_model(ix, int(blocks[i]), pats[i], int(starts[i]),
                             int(sp[i]), int(ep[i]), 12, 2)
                for i in range(len(sp))]
        model = np.array([r[:3] for r in rows]).T
        # the whole index clamps the rows past its table to its last row
        clamp = Tables(whole)
        clamped = np.array([extend_model(clamp, int(blocks[i]), pats[i],
                                         int(starts[i]), int(sp[i]),
                                         int(ep[i]), 12, 2)[:3]
                            for i in range(16)]).T
        assert clamp.row(1 << 30).any()
        assert (clamped != model[:, :16]).any(), "a zero row is no clamp"
        got = kernels.fm_extend(td, T(blocks), torch.from_numpy(pats),
                                T(starts), T(sp), T(ep), 12, 2)
        want = run(lambda d, *a: jfm.extend_seeds(d, *a, 12, 2),
                   jnp.asarray(blocks, jnp.int32), jnp.asarray(pats),
                   jnp.asarray(starts, jnp.int32),
                   jnp.asarray(sp.astype(np.uint32)),
                   jnp.asarray(ep.astype(np.uint32)))
    else:
        rng = np.random.default_rng(23)
        n = 400
        block = rng.integers(0, 2, n)
        i = np.array([rng.integers(0, idx.blocks[b].n) for b in block])
        i[:40] = np.array([idx.blocks[b].n for b in block[:40]]) \
            + rng.integers(0, 5000, 40)
        i[40:44] = U32
        valid = rng.random(n) < 0.85
        rows = [locate_model(ix, int(block[a]), int(i[a]), bool(valid[a]))
                for a in range(n)]
        assert {r[1] for r in rows if r[2]} == set(range(td.sa_rate))
        model = np.array([[r[0] for r in rows]])
        got = (kernels.fm_locate(td, T(block), T(i),
                                 torch.from_numpy(valid)),)
        want = (run(jfm.locate, jnp.asarray(block, jnp.int32),
                    jnp.asarray(i.astype(np.uint32)), jnp.asarray(valid)),)
        same(got[0], kernels.fm_locate(whole, T(block), T(i),
                                       torch.from_numpy(valid)),
             "sharded vs whole index")
    for col in range(len(model)):
        same(model[col], want[col], f"model vs JAX, output {col}")
        same(got[col], want[col], f"wrapper vs JAX, output {col}")
