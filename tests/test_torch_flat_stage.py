"""PyTorch port, the compact candidate stage's flat buffer (ops/kernels.py
flat_expand, flat_dedup, scatter_back, select_se; kernels csrc/flat.cu):
a scalar model of each kernel's loop (the expansion's per-block sums, its
per-block scan of the frames and a warp per frame writing the frame's
slots; the dedup's and the scatter back's warp per row over the row's
segment of the sorted keys, found by binary search; the selection's warp
per read, lane minima merged by a butterfly) is held to the plain
version, `*_ref`, on seeded inputs with chip_smoke's edge rows, and on the
arguments a real batch hands the wrappers.  The lane counts of fm_locate
and verify_fused_gather (n_lanes) hold lanes past them at 0 / INF.  And
map_batch_device / map_batch_pe_device, which now run the flat buffer with
its lane counts at every flat_chunks, equal the JAX package's records at
flat_chunks 0, 2 and 3, directional and PBAT, in the Gbp-scale
configuration on a small planted-repeat genome (one JAX compile per
configuration: the reference's records do not depend on flat_chunks).
The kernels themselves are held to their plain versions on the card by
chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bitmapperbs_tpu.config import AlignerConfig as JConfig  # noqa: E402
from bitmapperbs_tpu.index.build import build_index  # noqa: E402
from bitmapperbs_tpu.index.device import upload_index as jupload  # noqa: E402
from bitmapperbs_tpu.models import aligner as jal  # noqa: E402
from bitmapperbs_tpu.models import paired as jpaired  # noqa: E402
from bitmapperbs_tpu.utils.simulate import (repeat_genome_fasta,  # noqa: E402
                                            simulate_pairs, simulate_reads)
from bitmapperbs_tpu_torch import constants as K  # noqa: E402
from bitmapperbs_tpu_torch.config import AlignerConfig  # noqa: E402
from bitmapperbs_tpu_torch.index.device import upload_index  # noqa: E402
from bitmapperbs_tpu_torch.models import aligner as tal  # noqa: E402
from bitmapperbs_tpu_torch.models import paired as tpaired  # noqa: E402
from bitmapperbs_tpu_torch.models.host import prepare_batch  # noqa: E402
from bitmapperbs_tpu_torch.ops import fm, kernels  # noqa: E402
from chip_smoke import (flat_cap_cuts, flat_expand_inputs,  # noqa: E402
                        flat_scores, flat_sorted_keys, select_grids)

INF, INV, MASK = K.INF_SCORE, 0xFFFFFFFF, 0xFFFFFFFF
FRAMES = 64                     # csrc/flat.cu kFrames
SENT = -7                       # a slot no kernel wrote
DIRECTIONAL = ((0, 0), (0, 1))
PBAT = ((0, 0), (0, 1), (1, 0), (1, 1))


def _blocks(frames):
    return tuple(b for _, b in frames)


def _same(got: dict, want: dict):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (k, g.dtype, w.dtype, g.shape, w.shape)
        assert torch.equal(g, w), (k, int((g != w).sum()))


# ---- scalar models of the kernels' loops ------------------------------------

def expand_model(sp, ep, starts, lengths, blocks, max_occ, LB, CAP,
                 frames_per_block=FRAMES):
    """btbs_flat_expand: expand_totals_kernel, then expand_write_kernel's
    blocks (the sums of the blocks before, the block's scan, gdrop, a warp
    per frame writing its slots, the tail past n_used)."""
    sp, ep, lengths = sp.numpy(), ep.numpy(), lengths.numpy()
    B, F, S = sp.shape
    st = np.broadcast_to(starts.numpy(), (B, F, S))
    R = B * F
    bits = sum(b << f for f, b in enumerate(blocks))
    assert frames_per_block % F == 0

    def kept(r, s):
        c = (ep.reshape(R, S)[r, s] - sp.reshape(R, S)[r, s]) & MASK
        return int(c) if 0 < c <= max_occ else 0

    def total(r):
        return sum(kept(r, s) for s in range(S))

    nblk = -(-R // frames_per_block)
    sums = [sum(min(total(r), LB) for r in range(k * frames_per_block,
                                                 min(R, (k + 1)
                                                     * frames_per_block)))
            for k in range(nblk)]
    out = {k: np.full(CAP, SENT, np.int64)
           for k in ("sa_row", "st", "len_b", "fidx", "blk")}
    ok = np.full(CAP, SENT, np.int64)
    overflow = np.zeros(R, bool)
    gdrop = np.zeros(B, bool)
    n_used = sum(sums)
    for k in range(nblk):
        r0 = k * frames_per_block
        before = sum(sums[:k])
        occ = []
        for t in range(frames_per_block):
            r = r0 + t
            if r < R:
                tot = total(r)
                overflow[r] = tot > LB
                occ.append(min(tot, LB))
            else:
                occ.append(0)
        base = [before + sum(occ[:t]) for t in range(frames_per_block)]
        for t in range(0, frames_per_block, F):
            if r0 + t < R:
                gdrop[(r0 + t) // F] = any(
                    base[t + f] + occ[t + f] > CAP and occ[t + f] > 0
                    for f in range(F))
        for i in range(frames_per_block):            # a warp per frame
            r = r0 + i
            if r >= R:
                break
            if occ[i] == 0 or base[i] >= CAP:
                continue
            cnt = [kept(r, s) for s in range(S)]
            runs = [None] * S
            for s in range(S):
                rank = sum(c < cnt[s] or (c == cnt[s] and q < s)
                           for q, c in enumerate(cnt))
                runs[rank] = [cnt[s], 0, int(sp.reshape(R, S)[r, s]),
                              int(st.reshape(R, S)[r, s])]
            acc = 0
            for run in runs:
                run[1] = acc
                acc += run[0]
            b = r // F
            for j in range(occ[i]):
                g = base[i] + j
                if g >= CAP:
                    break
                q = 0
                for s in range(1, S):
                    if runs[s][1] <= j:
                        q = s
                c, offs, spq, start = runs[q]
                assert 0 < c and offs <= j < offs + c
                for key, v in (("sa_row", (spq + j - offs) & MASK),
                               ("st", start), ("len_b", lengths[b]),
                               ("fidx", r), ("blk", (bits >> (r % F)) & 1)):
                    assert out[key][g] == SENT
                    out[key][g] = v
                ok[g] = 1
    for g in range(n_used, CAP):                     # the tail
        for key in out:
            out[key][g] = 0
        ok[g] = 0
    assert (ok != SENT).all()                        # every slot written once
    return {**{k: torch.from_numpy(v) for k, v in out.items()},
            "ok": torch.from_numpy(ok.astype(bool)),
            "n_used": torch.tensor([n_used], dtype=torch.int64),
            "overflow": torch.from_numpy(overflow.reshape(B, F)),
            "gdrop": torch.from_numpy(gdrop)}


def _lower_bound(keys, n, x):
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) >> 1
        if keys[mid] < x:
            lo = mid + 1
        else:
            hi = mid
    return lo


def dedup_model(keyS, perm, len_b, overflow, blocks, Kc):
    """btbs_flat_dedup: n_valid by binary search; a warp per row walks its
    segment 32 keys at a time, ranks by ballot; the tail past n_valid."""
    keyS, perm, len_b = keyS.tolist(), perm.tolist(), len_b.tolist()
    ovf = overflow.numpy().reshape(-1)
    CAP, R, F = len(keyS), ovf.size, len(blocks)
    bits = sum(b << f for f, b in enumerate(blocks))
    out = {k: np.full(CAP, SENT, np.int64)
           for k in ("keep", "rank", "cand", "rowC", "blkS", "lenS")}
    ovf_out = np.zeros(R, bool)
    n_valid = _lower_bound(keyS, CAP, R << 32)
    for r in range(R):
        lo = _lower_bound(keyS, n_valid, r << 32)
        hi = _lower_bound(keyS, n_valid, (r + 1) << 32)
        before = 0
        for i0 in range(lo, hi, 32):
            lanes = [i0 + lane for lane in range(32)]
            uniq = [i < hi and (i == lo or keyS[i] != keyS[i - 1])
                    for i in lanes]
            for lane, i in enumerate(lanes):
                if i >= hi:
                    continue
                rk = before + sum(uniq[:lane])
                kp = uniq[lane] and rk < Kc
                for key, v in (("keep", kp), ("rank", rk),
                               ("cand", keyS[i] & MASK if kp else 0),
                               ("rowC", r), ("blkS", (bits >> (r % F)) & 1),
                               ("lenS", len_b[perm[i]])):
                    assert out[key][i] == SENT
                    out[key][i] = v
            before += sum(uniq)
        ovf_out[r] = ovf[r] | (before > Kc)
    for i in range(n_valid, CAP):
        for key, v in (("keep", 0), ("rank", 0), ("cand", 0),
                       ("rowC", R - 1), ("blkS", (bits >> ((R - 1) % F)) & 1),
                       ("lenS", len_b[perm[i]])):
            out[key][i] = v
    assert all((v != SENT).all() for v in out.values())
    res = {k: torch.from_numpy(v) for k, v in out.items()}
    res["keep"] = res["keep"].to(torch.bool)
    return {**res, "overflow": torch.from_numpy(ovf_out.reshape(
        overflow.shape)), "n_valid": torch.tensor([n_valid])}


def scatter_back_model(keyS, keep, rank, score, lengths, blocks, L, e, Kc):
    """btbs_scatter_back: a warp per row fills the row's Kc slots, then
    writes each kept lane of its segment with score <= e at its rank."""
    keyS, keep, rank = keyS.tolist(), keep.tolist(), rank.tolist()
    score, lengths = score.tolist(), lengths.tolist()
    B, F = len(lengths), len(blocks)
    s_d = np.full((B * F, Kc), SENT, np.int32)
    fwd = np.full((B * F, Kc), SENT, np.int64)
    fa = np.full((B * F, Kc), SENT, np.int64)
    for r in range(B * F):
        s_d[r], fwd[r], fa[r] = INF, INV, INV
        lo = _lower_bound(keyS, len(keyS), r << 32)
        hi = _lower_bound(keyS, len(keyS), (r + 1) << 32)
        rev = blocks[r % F] == 1
        for i in range(lo, hi):
            if keep[i] and score[i] <= e:
                cand = keyS[i] & MASK
                s_d[r, rank[i]] = score[i]
                fa[r, rank[i]] = cand
                fwd[r, rank[i]] = ((L - cand - lengths[r // F]) & MASK
                                   if rev else cand)
    return {"score": torch.from_numpy(s_d.reshape(B, F, Kc)),
            "fwd": torch.from_numpy(fwd.reshape(B, F, Kc)),
            "frame_a": torch.from_numpy(fa.reshape(B, F, Kc))}


def select_model(grids, e):
    """btbs_select_se: a warp per read; each lane's least (score << 40 |
    fwd << 8 | bp, frame_a) over its slots, a butterfly of shuffles, then
    the second pass's least score, merged the same way."""
    score, fwd, fa = (grids[k].numpy() for k in ("score", "fwd", "frame_a"))
    bp = grids["bp"].numpy()
    B, F, Kc = score.shape
    out = {k: [] for k in ("best_score", "best_bp", "best_anchor",
                           "second_score")}
    for b in range(B):
        best = [((1 << 64) - 1, (1 << 64) - 1)] * 32
        for f in range(F):
            for k in range(Kc):
                h = (int(score[b, f, k]) << 40 | int(fwd[b, f, k]) << 8
                     | int(bp[b, f, k]) & 0xFF)
                best[k % 32] = min(best[k % 32], (h, int(fa[b, f, k])))
        for o in (16, 8, 4, 2, 1):
            best = [min(best[lane], best[lane ^ o]) for lane in range(32)]
        h, fa_best = best[0]
        assert all(x == best[0] for x in best)
        bp_best = h & 0xFF
        sec = [INF] * 32
        for f in range(F):
            for k in range(Kc):
                a = int(fa[b, f, k])
                if bp[b, f, k] != bp_best or abs(a - fa_best) > e:
                    sec[k % 32] = min(sec[k % 32], int(score[b, f, k]))
        for o in (16, 8, 4, 2, 1):
            sec = [min(sec[lane], sec[lane ^ o]) for lane in range(32)]
        out["best_score"].append(h >> 40)
        out["best_bp"].append(bp_best)
        out["best_anchor"].append(fa_best)
        out["second_score"].append(sec[0])
    res = {k: torch.tensor(v, dtype=torch.int64) for k, v in out.items()}
    for k in ("best_score", "second_score"):
        res[k] = res[k].to(torch.int32)
    return {**res, "overflow": grids["overflow"], "gdrop": grids["gdrop"]}


# ---- the models against the plain versions, seeded inputs and edge rows ----

def _expand_args(seed, B, frames, shared, max_occ=128, LB=256, S=5):
    x = flat_expand_inputs(seed, B, len(frames), S, max_occ, LB, shared)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    return (t["sp"], t["ep"], t["starts"], t["lengths"], _blocks(frames),
            max_occ, LB)


@pytest.mark.parametrize("frames,shared,fpb", [
    (DIRECTIONAL, True, FRAMES), (PBAT, False, FRAMES),
    (PBAT, True, 8), (DIRECTIONAL, False, 4)])
def test_expand_model_equals_plain(frames, shared, fpb):
    """At every buffer size of flat_cap_cuts: the batch's own, one slot, a
    run straddling CAP, a cut at a frame boundary, n_used exactly and past
    it (n_used > CAP: every slot filled, gdrop); fpb < 256 runs the model's
    cross-block scan on a small batch."""
    sp, ep, starts, lengths, blocks, max_occ, LB = _expand_args(
        3 + fpb, 40, frames, shared)
    base = kernels.flat_expand_ref(sp, ep, starts, lengths, blocks, max_occ,
                                   LB, 40 * 12)
    occ = (base["ok"].sum(), int(base["n_used"]))
    totals = tal.order_seeds(sp, ep, starts, max_occ)[0].sum(-1)
    frame_occ = totals.clamp(max=LB).reshape(-1).numpy()
    assert int(frame_occ.sum()) == occ[1]
    assert base["overflow"][2].all() and not base["overflow"][0].any()
    cuts = flat_cap_cuts(occ[1], frame_occ, 40 * 12)
    assert min(cuts) < occ[1] < max(cuts)
    for CAP in cuts:
        want = kernels.flat_expand_ref(sp, ep, starts, lengths, blocks,
                                       max_occ, LB, CAP)
        got = expand_model(sp, ep, starts, lengths, blocks, max_occ, LB, CAP,
                           fpb)
        _same(got, want)
        assert bool(want["gdrop"].any()) == (occ[1] > CAP)
        assert int(want["ok"].sum()) == min(occ[1], CAP)


@pytest.mark.parametrize("frames,Kc", [(DIRECTIONAL, 8), (PBAT, 5)])
def test_dedup_and_scatter_back_models_equal_plain(frames, Kc):
    """Seeded sorted keys with the edge rows (more than Kc distinct anchors,
    a row with no key, equal anchors in two rows, duplicates, anchors near 0
    and L), then the scatter back of seeded scores (0..e, over e, INF)."""
    B, F, CAP, L, e = 24, len(frames), 600, 5_000, 3
    x = flat_sorted_keys(11 + F, B, F, Kc, CAP, L)
    keyS, perm = torch.sort(torch.from_numpy(x["key"]), stable=True)
    len_b = torch.from_numpy(x["len_b"])
    ovf = torch.from_numpy(x["overflow"])
    blocks = _blocks(frames)
    want = kernels.flat_dedup_ref(keyS, perm, len_b, ovf, blocks, Kc)
    _same(dedup_model(keyS, perm, len_b, ovf, blocks, Kc), want)
    assert bool(want["overflow"][0, 0]) and int(want["keep"].sum()) > Kc
    assert int(want["n_valid"]) < CAP
    score = torch.from_numpy(flat_scores(5, want["keep"].numpy(), e))
    lengths = torch.from_numpy(x["lengths"])
    args = (keyS, want["keep"], want["rank"], score, lengths, blocks, L, e,
            Kc)
    got = scatter_back_model(*args)
    plain = kernels.scatter_back_ref(*args)
    _same(got, plain)
    assert (plain["score"] < INF).any() and (plain["fwd"] > L).any()


@pytest.mark.parametrize("frames,Kc", [(DIRECTIONAL, 40), (PBAT, 7)])
def test_select_model_equals_plain(frames, Kc):
    """Seeded grids with the edge reads: none valid, ties of score, of
    (score, fwd) across frames, of (score, fwd, bp) at two frame anchors,
    seconds e and e + 1 away, the best in the last slot."""
    B, e = 48, 2
    g = select_grids(21, B, frames, Kc, e, 10_000)
    grids = {k: torch.from_numpy(g[k]) for k in ("score", "fwd", "frame_a")}
    grids["bp"] = torch.from_numpy(g["bp"])[None, :, None].expand(
        B, len(frames), Kc)
    grids["overflow"] = torch.zeros(B, dtype=torch.bool)
    grids["gdrop"] = torch.ones(B, dtype=torch.bool)
    want = kernels.select_se_ref(grids, e)
    _same(select_model(grids, e), want)
    assert int(want["best_score"][0]) == INF
    assert int(want["best_anchor"][3]) == 75
    assert int(want["second_score"][4]) == 2


# ---- the models on the arguments a real batch hands the wrappers ------------

GBP = dict(max_errors=4, indels=True, read_len_bucket=96, seed_ext_max=20,
           seed_ext_occ=4, max_candidates=128, max_seed_occ=128,
           locate_budget=256)
# what cli.autotune_for_genome sets at Gbp scale for --pbat (flat cap 192 in
# 3 chunks) and for --sensitive (256 candidates in 2 chunks)
GBP_PBAT = dict(GBP, non_directional=True, locate_flat_cap=192)
B = 24


@pytest.fixture(scope="module")
def genome():
    """Planted dispersed / LINE-like / tandem repeats; reads and pairs over
    the whole genome, a quarter cut short."""
    idx = build_index(repeat_genome_fasta(np.random.default_rng(91),
                                          contigs=(30000, 15000)))
    sims = simulate_reads(idx.genome, B, read_len=90, seed=92,
                          sub_rate=0.01, indel_rate=0.005)
    cut = np.random.default_rng(9).integers(50, 91, B)
    reads = [s.codes[:c] if i % 4 == 0 else s.codes
             for i, (s, c) in enumerate(zip(sims, cut))]
    pairs = [(a.codes, b.codes) for a, b in simulate_pairs(
        idx.genome, B, read_len=80, seed=93, min_insert=150, max_insert=260,
        sub_rate=0.01, indel_rate=0.01)]
    return idx, jupload(idx), upload_index(idx), reads, pairs


def _captured(td, cfg, reads):
    """The arguments of the four wrappers and of the lane-count kernels in
    one map_batch_device call."""
    names = ("flat_expand", "flat_dedup", "scatter_back", "select_se",
             "fm_locate", "verify_fused_gather")
    saved = {n: getattr(kernels, n) for n in names}
    seen = {}

    def rec(name):
        def call(*a, **k):
            seen[name] = (a, k)
            return saved[name](*a, **k)
        return call

    arr, lens = prepare_batch(reads, 96, B)
    try:
        for n in names:
            setattr(kernels, n, rec(n))
        tal.map_batch_device(td, cfg, torch.from_numpy(arr),
                             torch.from_numpy(lens),
                             min_read_len=int(lens.min()))
    finally:
        for n, f in saved.items():
            setattr(kernels, n, f)
    assert set(seen) == set(names), set(seen)
    return seen


@pytest.mark.parametrize("extra", [GBP, GBP_PBAT])
def test_models_on_a_real_batch(genome, extra):
    _, _, td, reads, _ = genome
    seen = _captured(td, AlignerConfig(batch_size=B, **extra), reads)
    a, k = seen["flat_expand"]
    assert not k
    _same(expand_model(*a), kernels.flat_expand_ref(*a))
    a, _ = seen["flat_dedup"]
    _same(dedup_model(*a), kernels.flat_dedup_ref(*a))
    a, _ = seen["scatter_back"]
    _same(scatter_back_model(*a), kernels.scatter_back_ref(*a))
    a, _ = seen["select_se"]
    _same(select_model(*a), kernels.select_se_ref(*a))
    # the lane counts the path hands locate and the verify
    assert torch.equal(seen["fm_locate"][1]["n_lanes"],
                       kernels.flat_expand_ref(*seen["flat_expand"][0])[
                           "n_used"])
    assert torch.equal(seen["verify_fused_gather"][1]["n_lanes"],
                       kernels.flat_dedup_ref(*seen["flat_dedup"][0])[
                           "n_valid"])


# ---- the lane counts of fm_locate and verify_fused_gather -------------------

def test_lane_counts_hold_lanes_past_them(genome):
    """A lane at or past n_lanes gives 0 (locate) or INF (the verify) and
    every lane below it what the call without a count gives; a count of 0,
    inside, exactly the lanes and past them."""
    _, _, td, reads, _ = genome
    cfg = AlignerConfig(batch_size=B, **GBP)
    seen = _captured(td, cfg, reads)
    (dix, blk, i, valid), _ = seen["fm_locate"]
    g_args, _ = seen["verify_fused_gather"]
    n = blk.shape[0]
    full_tp = kernels.fm_locate(dix, blk, i, valid)
    full_sc = kernels.verify_fused_gather(*g_args)
    for count in (0, 1, n // 3, n, n + 9):
        t = torch.tensor([count], dtype=torch.int64)
        below = torch.arange(n) < count
        tp = fm.locate(dix, blk, i, valid, n_lanes=t)
        assert torch.equal(tp[below], full_tp[below])
        assert (tp[~below] == 0).all()
        sc = kernels.verify_fused_gather(*g_args, n_lanes=t)
        assert torch.equal(sc[below], full_sc[below])
        assert (sc[~below] == INF).all() and sc.dtype == torch.int32
    with pytest.raises(ValueError, match="lane count"):
        kernels.fm_locate(dix, blk, i, valid,
                          n_lanes=torch.tensor([3], dtype=torch.int32))
    with pytest.raises(ValueError, match="lane count"):
        kernels.verify_fused_gather(*g_args, n_lanes=torch.tensor([1, 2]))


# ---- the device calls against the JAX package at every flat_chunks ----------

CHUNK_CASES = [(pbat, chunks) for pbat in (False, True)
               for chunks in (0, 2, 3)]
PE = dict(paired=True, min_insert=100, max_insert=450)


def _cfgs(pbat, chunks, **kw):
    extra = dict(GBP_PBAT if pbat else GBP, flat_chunks=chunks,
                 batch_size=B, **kw)
    return AlignerConfig(**extra), JConfig(**extra)


def _leaves(d, path=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}.")
        else:
            yield path + k, v


@pytest.fixture(scope="module")
def jax_records(genome):
    """The JAX package's device-call records per (configuration, SE / PE),
    one compile each, at flat_chunks 0: the reference's own
    test_flat_chunks_bit_identical holds its records equal at every
    flat_chunks, so the port at 0, 2 and 3 is held to these."""
    _, jd, _, reads, pairs = genome
    cache = {}

    def get(pbat, paired):
        if (pbat, paired) not in cache:
            _, jcfg = _cfgs(pbat, 0, **(PE if paired else {}))
            if paired:
                a1, l1 = prepare_batch([p[0] for p in pairs], 96, B)
                a2, l2 = prepare_batch([p[1] for p in pairs], 96, B)
                want = jpaired.map_batch_pe_device(
                    jd, jcfg, jnp.asarray(a1), jnp.asarray(l1),
                    jnp.asarray(a2), jnp.asarray(l2))
            else:
                arr, lens = prepare_batch(reads, 96, B)
                want = jal.map_batch_device(jd, jcfg, jnp.asarray(arr),
                                            jnp.asarray(lens))
            cache[pbat, paired] = {k: np.asarray(v).astype(np.int64)
                                   for k, v in _leaves(want)}
        return cache[pbat, paired]

    return get


def _equal(got: dict, want: dict):
    got = dict(_leaves(got))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      want[k], err_msg=k)


@pytest.mark.parametrize("pbat,chunks", CHUNK_CASES)
def test_map_batch_device_matches_jax(genome, jax_records, pbat, chunks):
    _, _, td, reads, _ = genome
    cfg, _ = _cfgs(pbat, chunks)
    arr, lens = prepare_batch(reads, 96, B)
    got = tal.map_batch_device(td, cfg, torch.from_numpy(arr),
                               torch.from_numpy(lens),
                               min_read_len=int(lens.min()))
    _equal(got, jax_records(pbat, False))
    assert int((got["best_score"] < INF).sum()) > B // 2


@pytest.mark.parametrize("pbat,chunks", CHUNK_CASES)
def test_map_batch_pe_device_matches_jax(genome, jax_records, pbat, chunks):
    _, _, td, _, pairs = genome
    cfg, _ = _cfgs(pbat, chunks, **PE)
    a1, l1 = prepare_batch([p[0] for p in pairs], 96, B)
    a2, l2 = prepare_batch([p[1] for p in pairs], 96, B)
    got = tpaired.map_batch_pe_device(
        td, cfg, torch.from_numpy(a1), torch.from_numpy(l1),
        torch.from_numpy(a2), torch.from_numpy(l2),
        min_read_len1=int(l1.min()), min_read_len2=int(l2.min()))
    _equal(got, jax_records(pbat, True))
    assert int(got["pair_valid"].sum()) > B // 2
