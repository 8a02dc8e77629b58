"""PyTorch port, the paired-end pair join (ops/kernels.pair_join, kernel
csrc/pair.cu): a scalar model of the kernel's per-pair loop (a block of
four warps: each row's valid entries packed by ballot, 32 slots at a time,
with the least (anchor, score) of every slot beside them; the 128 threads'
register minima over the n1 x n2 cells merged by a butterfly in each warp
and then across the warps; the second pass over the same lists) is held to
the plain version, pair_join_ref, on seeded
grids and on chip_smoke's edge rows, directional and PBAT; and
map_batch_pe_device, whose pair join goes through the wrapper, still equals
the JAX package's on one small index.  The kernel itself is held to
pair_join_ref on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bitmapperbs_tpu.config import AlignerConfig as JConfig  # noqa: E402
from bitmapperbs_tpu.index.build import build_index  # noqa: E402
from bitmapperbs_tpu.index.device import upload_index as jupload  # noqa: E402
from bitmapperbs_tpu.models import paired as jpaired  # noqa: E402
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,  # noqa: E402
                                            simulate_pairs)
from bitmapperbs_tpu_torch import constants as K  # noqa: E402
from bitmapperbs_tpu_torch.config import AlignerConfig  # noqa: E402
from bitmapperbs_tpu_torch.index.device import upload_index  # noqa: E402
from bitmapperbs_tpu_torch.models import paired as tpaired  # noqa: E402
from bitmapperbs_tpu_torch.models.host import prepare_batch  # noqa: E402
from bitmapperbs_tpu_torch.ops import kernels  # noqa: E402
from bitmapperbs_tpu_torch.oracle.pipeline import se_frames  # noqa: E402
from chip_smoke import pair_join_grids, plant_pair_join_rows  # noqa: E402

INF, INV, MASK = K.INF_SCORE, 0xFFFFFFFF, 0xFFFFFFFF
THREADS = 128                   # csrc/pair.cu: kWarps warps per pair
B = 64
L = 50_000
E = 3


def _stage_row(s, f):
    """stage_row: (valid scores, valid anchors, least (anchor, score) of
    all slots) of one frame row, each valid slot written where the ballot
    puts it: the count before its chunk plus the valid lanes below it."""
    Kc = len(s)
    ls, lf = [None] * Kc, [None] * Kc
    n, least = 0, None
    for k0 in range(0, Kc, 32):
        vote = [k0 + lane < Kc and s[k0 + lane] < INF for lane in range(32)]
        for lane in range(32):
            k = k0 + lane
            if vote[lane]:
                at = n + sum(vote[:lane])
                ls[at], lf[at] = s[k], f[k] & MASK
            if k < Kc:
                key = ((f[k] & MASK) << 32) | s[k]
                least = key if least is None else min(least, key)
        n += sum(vote)
    assert None not in ls[:n] and ls[n:] == [None] * (Kc - n)
    return ls[:n], lf[:n], least


def _frame_anchor(fwd, bp, m):
    return fwd if bp >> 1 == 0 else (L - fwd - m) & MASK


def _ok(a1, a2, fwd1, m1, m2, lo, hi):
    ffwd, frev = (a1, a2) if fwd1 else (a2, a1)
    insert = (frev + (m2 if fwd1 else m1) - ffwd) & MASK
    return ffwd <= frev and lo <= insert <= hi


def _cells(t, n1, n2):
    """The cells (i, j) thread t of the block walks: c = t, t + 128, ...,
    (i, j) stepped as for_cells steps them: by (128 // n2, 128 % n2) with a
    carry, not divided per cell."""
    if t >= n1 * n2:
        return
    di, dj = divmod(THREADS, n2)
    i, j = divmod(t, n2)
    for _ in range(t, n1 * n2, THREADS):
        yield i, j
        i, j = i + di, j + dj
        if j >= n2:
            i, j = i + 1, j - n2


@pytest.mark.parametrize("n1, n2", [(1, 1), (3, 5), (1, 200), (200, 1),
                                    (7, 128), (128, 128), (33, 129)])
def test_cell_stepping_is_row_major(n1, n2):
    """for_cells' stepping with a carry visits what c // n2, c % n2 would:
    every cell once, each thread its c = t, t + 128, ..."""
    seen = [(c // n2, c % n2) for t in range(THREADS)
            for c in range(t, n1 * n2, THREADS)]
    assert [ij for t in range(THREADS) for ij in _cells(t, n1, n2)] == seen
    assert sorted(seen) == [(i, j) for i in range(n1) for j in range(n2)]


def _block_min(keys):
    """A butterfly of shuffles in each warp, then the least of the warps'
    minima (block_lex_min); every thread gets the same key."""
    out = []
    for w in range(0, THREADS, 32):
        warp = keys[w:w + 32]
        d = 16
        while d:
            warp = [min(warp[x], warp[x ^ d]) for x in range(32)]
            d >>= 1
        assert len(set(warp)) == 1
        out.append(warp[0])
    return min(out)


def pair_model(s1, f1, s2, f2, m1, m2, pairs, e, lo, hi):
    """One pair through the kernel's loop: s1 / f1 [F1][Kc], s2 / f2
    [F2][Kc] python ints.  Returns the nine outputs."""
    best = (2 * INF, INV, INV, 127, 127)
    best_s1 = INF
    lists = []
    for i1, i2, bp1, bp2, fwd1 in pairs:
        s1l, f1l, least1 = _stage_row(s1[i1], f1[i1])
        s2l, f2l, least2 = _stage_row(s2[i2], f2[i2])
        lists.append((s1l, f1l, s2l, f2l, bp1, bp2, fwd1))
        keys = []
        for t in range(THREADS):
            key = None                    # (sum, f1, f2, s1) of the thread
            for i, j in _cells(t, len(s1l), len(s2l)):
                if _ok(f1l[i], f2l[j], fwd1, m1, m2, lo, hi):
                    k = (s1l[i] + s2l[j], f1l[i], f2l[j], s1l[i])
                    key = k if key is None or k < key else key
            keys.append(key)
        if any(k is not None for k in keys):      # __syncthreads_or
            csum, cf1, cf2, cs1 = _block_min(
                [k if k is not None else (MASK,) * 4 for k in keys])
        else:                              # every cell at 2 INF
            csum, cf1, cf2, cs1 = (2 * INF, least1 >> 32, least2 >> 32,
                                   least1 & MASK)
        cand = (csum, cf1, cf2, bp1, bp2)
        if cand < best:
            best, best_s1 = cand, cs1
    psum, pf1, pf2, pbp1, pbp2 = best
    pa1 = _frame_anchor(pf1, pbp1, m1)
    pa2 = _frame_anchor(pf2, pbp2, m2)
    seconds = [2 * INF] * THREADS
    for s1l, f1l, s2l, f2l, bp1, bp2, fwd1 in lists:
        for t in range(THREADS):
            for i, j in _cells(t, len(s1l), len(s2l)):
                if not _ok(f1l[i], f2l[j], fwd1, m1, m2, lo, hi):
                    continue
                x1 = _frame_anchor(f1l[i], bp1, m1)
                x2 = _frame_anchor(f2l[j], bp2, m2)
                if bp1 != pbp1 or abs(x1 - pa1) > e or bp2 != pbp2 \
                        or abs(x2 - pa2) > e:
                    seconds[t] = min(seconds[t], s1l[i] + s2l[j])
    second = _block_min(seconds)
    return psum, pf1, pf2, pbp1, pbp2, best_s1, pa1, pa2, second


def _frames(pbat: bool):
    cfg = AlignerConfig(non_directional=pbat)
    return tuple(se_frames(cfg, mate=0)), tuple(se_frames(cfg, mate=1))


def _ref(g, frames1, frames2, lo, hi):
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    (psum, pf1, pf2, pbp1, pbp2), s1, pa1, pa2, second = \
        kernels.pair_join_ref(t["s1"], t["f1"], t["s2"], t["f2"], frames1,
                              frames2, t["m1"], t["m2"], L, E, lo, hi)
    return [x.numpy() for x in (psum, pf1, pf2, pbp1, pbp2, s1, pa1, pa2,
                                second)]


CASES = [(pbat, Kc, stray, lo, hi)
         for pbat in (False, True) for Kc in (4, 16, 40)
         for stray, lo, hi in ((False, 0, 60), (False, 30, 200),
                               (True, 0, 60))]


@pytest.mark.parametrize("pbat, Kc, stray, lo, hi", CASES)
def test_kernel_model_equals_plain(pbat, Kc, stray, lo, hi):
    """The scalar model of csrc/pair.cu's per-pair loop equals
    pair_join_ref row for row: seeded rows (candidates in random slots,
    some frames with more than 32), chip_smoke's edge rows over the first
    ones, directional (2 frame pairs) and PBAT (4)."""
    frames1, frames2 = _frames(pbat)
    g = pair_join_grids(Kc * 7 + pbat + 2 * stray, B, Kc, frames1, frames2,
                        L, E, lo, hi, stray=stray)
    n_planted = plant_pair_join_rows(g, frames1, frames2, L, E, lo, hi)
    want = _ref(g, frames1, frames2, lo, hi)
    pairs = kernels.frame_pairs(frames1, frames2)
    assert len(pairs) == (4 if pbat else 2)
    for b in range(B):
        got = pair_model(g["s1"][b].tolist(), g["f1"][b].tolist(),
                         g["s2"][b].tolist(), g["f2"][b].tolist(),
                         int(g["m1"][b]), int(g["m2"][b]), pairs, E, lo, hi)
        assert list(got) == [int(w[b]) for w in want], b
    valid = want[0] < 2 * INF
    # both kinds of row, and degenerate rows that still carry an anchor
    assert valid.any() and (~valid).any()
    assert (want[1][~valid] != INV).any()
    assert (want[8] < 2 * INF).any()
    assert n_planted == 10


def test_edge_rows_decide_as_designed():
    """What the plain version makes of chip_smoke's edge rows (directional,
    insert 0-60): the rows the kernel must get right on the card."""
    frames1, frames2 = _frames(False)
    g = pair_join_grids(3, 16, 8, frames1, frames2, L, E, 0, 60)
    plant_pair_join_rows(g, frames1, frames2, L, E, 0, 60)
    psum, pf1, pf2, pbp1, pbp2, s1, pa1, pa2, second = _ref(
        g, frames1, frames2, 0, 60)
    # no ok cell: degenerate, with frame pair 0's least anchors
    assert psum[0] == 2 * INF and pf1[0] == 1000 and s1[0] == 1
    # both sides empty: INVALID anchors, the first frame pair's bp codes
    assert (psum[1], pf1[1], pf2[1], s1[1]) == (2 * INF, INV, INV, INF)
    assert pbp1[1] < 127 and pbp2[1] < 127
    # mate 1 empty: INVALID mate-1 anchor, mate 2's anchor
    assert (psum[2], pf1[2], pf2[2]) == (2 * INF, INV, 5000)
    # inserts at min_insert and at max_insert are ok; one past is not
    assert psum[4] == 4 and psum[5] == 2 and psum[6] == 4
    # the forward mate after the reverse one: no proper pair
    assert psum[7] == 2 * INF
    # a second best e + 1 away, none at e
    assert psum[9] == 0 and second[9] == 1


@pytest.mark.parametrize("pbat", [False, True])
def test_wrapper_takes_plain_on_cpu_and_refuses_mixed(pbat):
    frames1, frames2 = _frames(pbat)
    g = pair_join_grids(5, 8, 4, frames1, frames2, L, E, 0, 60)
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    args = (t["s1"], t["f1"], t["s2"], t["f2"], frames1, frames2, t["m1"],
            t["m2"], L, E, 0, 60)
    before = dict(kernels.LAUNCHES)
    got = kernels.pair_join(*args)
    assert kernels.LAUNCHES == before               # no kernel ran
    want = kernels.pair_join_ref(*args)
    flat = lambda r: [*r[0], *r[1:]]                # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
    assert [x.dtype for x in flat(got)] == [torch.int32] + [torch.int64] * 4 \
        + [torch.int32] + [torch.int64] * 2 + [torch.int32]
    with pytest.raises(ValueError):                 # no silent path
        kernels.pair_join(t["s1"].to("meta"), *args[1:])
    with pytest.raises(ValueError):
        kernels.pair_join(t["s1"].to(torch.int64), *args[1:])


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(61)
    idx = build_index(random_genome_fasta(rng, contigs=(5000, 3000)))
    return idx, jupload(idx), upload_index(idx)


@pytest.mark.parametrize("pbat", [False, True])
def test_map_batch_pe_device_through_the_wrapper(small_index, pbat):
    """map_batch_pe_device, whose pair join is kernels.pair_join (its plain
    version on the CPU), equals the JAX package's device call, also on the
    pairs with no proper pair, whose degenerate join candidate reaches
    pair_a1 / pair_a2 / pair_s1 / pair_bp*: mates at two loci (often two
    contigs), inserts of 700-900 outside the range, an unmappable mate."""
    idx, jd, td = small_index
    kw = dict(max_errors=4, indels=True, paired=True, min_insert=100,
              max_insert=450, read_len_bucket=96, batch_size=B,
              non_directional=pbat)
    sims = simulate_pairs(idx.genome, B, read_len=80, seed=62,
                          min_insert=150, max_insert=400, sub_rate=0.01,
                          indel_rate=0.005)
    far = simulate_pairs(idx.genome, 8, read_len=80, seed=63, min_insert=700,
                         max_insert=900)
    noise = np.random.default_rng(64).integers(0, 4, (8, 80), dtype=np.uint8)
    pairs = [(a.codes, b.codes) for a, b in sims]
    for i in range(8):
        pairs[i] = (sims[i][0].codes, sims[B // 2 + i][1].codes)
        pairs[8 + i] = (far[i][0].codes, far[i][1].codes)
        pairs[16 + i] = (sims[16 + i][0].codes, noise[i])
    a1, l1 = prepare_batch([p[0] for p in pairs], 96, B)
    a2, l2 = prepare_batch([p[1] for p in pairs], 96, B)
    want = jpaired.map_batch_pe_device(jd, JConfig(**kw), jnp.asarray(a1),
                                       jnp.asarray(l1), jnp.asarray(a2),
                                       jnp.asarray(l2))
    seen = []
    real = kernels.pair_join

    def spy(*a, **k):
        seen.append(a[4:6])
        return real(*a, **k)

    kernels.pair_join = spy
    try:
        got = tpaired.map_batch_pe_device(
            td, AlignerConfig(**kw), *(torch.from_numpy(x) for x in
                                       (a1, l1, a2, l2)),
            min_read_len1=int(l1.min()), min_read_len2=int(l2.min()))
    finally:
        kernels.pair_join = real
    assert len(seen) == 1 and len(seen[0][0]) == (4 if pbat else 2)
    for k in ("pair_valid", "pair_sum", "pair_second_sum", "pair_s1",
              "pair_a1", "pair_a2", "pair_bp1", "pair_bp2"):
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      np.asarray(want[k]).astype(np.int64),
                                      err_msg=k)
    valid = got["pair_valid"].numpy()
    assert valid[24:].sum() > (B - 24) // 2
    degenerate = ~valid & (got["pair_a1"].numpy() != 0xFFFFFFFF)
    assert degenerate[:24].sum() >= 12, degenerate[:24]
