"""PyTorch port: the fused verify with its window gather inside.  Its plain
version (what the wrapper runs on CPU tensors) equals the JAX package's
window_planes followed by its fused verify path, run as the JAX tests run it
on the CPU (the jnp sequence, and the Pallas kernel in interpret mode),
exactly, on lanes whose windows wrap below position 0, run past the genome
end, come from both orientations and carry short reads.  For buckets over 256
bp (9..32 read words) a scalar per-lane model of the CUDA kernel (a lane on a
group of threads, each holding a few words; window words fetched as the
Hamming words and the Myers columns advance; a column's carry across the
group from the threads' generate / propagate ballots) is held to the plain
version as well.  On genome planes split over 2 and 3 shards (a sharded
index) the kernels' SHARD instances are modelled the same way: the inline
window fetch of the narrow kernel and the streamed one of the wide kernel
read each row from the shard that holds it, equal to the plain version on
the shard set, to the whole table's result and to the JAX package's sharded
window gather."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from bitmapperbs_tpu import constants as K  # noqa: E402
from bitmapperbs_tpu.index.build import parse_fasta  # noqa: E402
from bitmapperbs_tpu.models.aligner import (_peq_from_planes,  # noqa: E402
                                            _shift_planes)
from bitmapperbs_tpu.ops import verify as jv  # noqa: E402
from bitmapperbs_tpu.utils.simulate import random_genome_fasta  # noqa: E402
from bitmapperbs_tpu_torch.index.device import \
    _device_layout_planes  # noqa: E402
from bitmapperbs_tpu_torch.ops import kernels  # noqa: E402
from bitmapperbs_tpu_torch.ops import verify as tv  # noqa: E402
from test_torch_rescue_scan import (WindowModel, mask_lt,  # noqa: E402
                                    myers_column_words, split_planes)

U32 = 0xFFFFFFFF


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=msg)


def lanes(rng, n, m, e, n_rows=37):
    """A toy genome's planes and n candidate lanes: reads cut at the anchor
    from either orientation with conversions, substitutions and small
    shifts (ham <= e and ham > e both occur), a table of n_rows read-plane
    rows that the lanes pick from, short reads, anchors within e of
    position 0 (the window start wraps) and within m of the end."""
    genome = parse_fasta(random_genome_fasta(
        rng, contigs=(max(900, 3 * m), 500)))
    L = genome.length
    gp = _device_layout_planes(genome)
    ref = np.stack([genome.codes, genome.rc_codes()])
    row = rng.integers(0, n_rows, n)
    orient_r = rng.integers(0, 2, n_rows)
    anchor_r = rng.integers(0, L - m, n_rows)
    anchor_r[:4] = rng.integers(0, e + 1, 4)
    anchor_r[4:8] = L - rng.integers(1, m, 4)
    clean = slice(8, min(12, n_rows))                # whole inside contig 1
    anchor_r[clean] = 256 + rng.integers(0, 100, 4)[:len(anchor_r[clean])]
    lens_r = np.where(rng.random(n_rows) < 0.4,
                      rng.integers(m // 2, m + 1, n_rows), m - 6)
    pos = anchor_r[:, None] + np.arange(m)
    reads = ref[orient_r[:, None], np.clip(pos, 0, L - 1)]
    reads[pos >= L] = K.N_CODE
    reads[(reads == K.C) & (rng.random(reads.shape) < 0.7)] = K.T
    rate = rng.choice([0.0, 0.02, 0.08], n_rows)
    rate[clean] = 0.0                                # ham <= e at any width
    sub = rng.random(reads.shape) < rate[:, None]
    reads[sub] = (reads[sub] + 1) % 4
    reads[np.arange(m)[None, :] >= lens_r[:, None]] = K.N_CODE
    # lanes: mostly at their row's anchor (sometimes shifted by an indel-like
    # offset), some anywhere
    orient = orient_r[row]
    anchor = anchor_r[row] + np.where(rng.random(n) < 0.3,
                                      rng.integers(-2, 3, n), 0)
    far = rng.random(n) < 0.2
    anchor[far] = rng.integers(0, L, far.sum())
    orient[far] = rng.integers(0, 2, far.sum())
    anchor[0], anchor[1] = e - 1, L - m // 2         # planted in every case
    start = (anchor - e) & U32                       # wraps for anchor < e
    assert (start >= 0xFFFFF000).any() and (anchor + m > L).any()
    return gp, L, reads.astype(np.uint8), lens_r, row, orient, start


WIDE_CAPACITIES = tuple(kernels.WIDE_WORDS)   # the buckets' capacities


def wide_builds() -> list:
    """The read words per thread K of the wide gathering kernel's builds in
    csrc/verify.cu (the cases of fused_gather's dispatch)."""
    with open(kernels.SOURCES["verify"]) as f:
        src = f.read()
    return sorted(int(k) for k in re.findall(
        r"case (\d+): return launch_fused_gather_wide<", src))


def wide_capacity(wd: int) -> int:
    """The word capacity of the build that takes wd read words."""
    return next(nw for nw in WIDE_CAPACITIES if wd <= nw)


def group_carries(gen: int, prop: int, gbase: int, T: int) -> list:
    """The carry into each thread of the group at warp lanes [gbase,
    gbase + T): gen / prop are the warp's ballots of "the thread's block
    carries out" and "it carries out or its sum is all ones" (G | P), every
    group's bits included.  A = G from the group's first lane up, B = G | P
    whole; the carries are (A + B) ^ A ^ B, bit by bit (no carry starts
    below the group, where A is 0)."""
    a, b = gen & (U32 << gbase) & U32, prop
    c = ((a + b) ^ a ^ b) & U32
    return [(c >> (gbase + t)) & 1 for t in range(T)]


def group_lane_model(gp, gwords, L, orient, start, planes, length, m, ncols,
                     e, K, gbase=0, noise=0):
    """One lane as verify_fused_gather_wide_kernel runs it with K words per
    thread on a group of T = ceil(Wd / K) threads at warp lanes [gbase,
    gbase + T), words aligned at the top: thread t holds words
    Wd - T K + t K + j, j < K (below 0: eq 0).  The Hamming count: each
    thread its words of the window streamed from its own first word, summed
    over the group.  Then (ham > e) per column: each thread adds its words
    with carry in 0 (g: carry out; p: all-ones sum), the warp's ballots
    (other groups' bits: `noise`) give the carry into each thread, the
    thread adds it in, hp / hn top bits go one thread up, and the last
    thread's last word gives the score.  planes: the lane's 3 * Wd
    read-plane words."""
    Wd = m // 32
    T = -(-Wd // K)
    k0 = [Wd - T * K + t * K for t in range(T)]
    ham = 0
    for t in range(T):
        win = WindowModel(gp, orient, start, gwords, L, max(k0[t], 0))
        cur = win.next()
        for k in range(max(k0[t], 0), k0[t] + K):
            nxt = win.next()
            a0, a1, an = (((c >> e) | (x << (32 - e))) & U32 if e else c
                          for c, x in zip(cur, nxt))
            d0, d1, dn = planes[k], planes[Wd + k], planes[2 * Wd + k]
            lmask = mask_lt(min(max(length - 32 * k, 0), 32))
            eqb = ~(a0 ^ d0) & ~(a1 ^ d1)
            match = (eqb | ((a0 & ~a1) & (d0 & d1))) & ~an & ~dn
            ham += bin(~match & lmask & U32).count("1")
            cur = nxt
    if ham <= e:
        return ham
    # per thread and word: PEQ rows 0..3 and the pad row (zero below word 0)
    table = [[[0] * K for _ in range(5)] for _ in range(T)]
    for t in range(T):
        for j in range(K):
            k = k0[t] + j
            if k < 0:
                continue
            r0, r1, rn = planes[k], planes[Wd + k], planes[2 * Wd + k]
            p = ~mask_lt(min(max(length - 32 * k, 0), 32)) & U32
            for row, bits in enumerate((~r0 & ~r1 & ~rn,
                                        (r0 & ~r1 & ~rn) | (r0 & r1 & ~rn),
                                        ~r0 & r1 & ~rn, r0 & r1 & ~rn, 0)):
                table[t][row][j] = (bits | p) & U32
    vp = [[U32] * K for _ in range(T)]
    vn = [[0] * K for _ in range(T)]
    other = U32 & ~(((1 << T) - 1) << gbase)     # the warp's other groups
    score = best = m
    win = WindowModel(gp, orient, start, gwords, L)
    for j0 in range(0, ncols, 32):
        a0, a1, an = win.next()
        for b in range(min(32, ncols - j0)):
            sym = 4 if (an >> b) & 1 \
                else ((a0 >> b) & 1) | (((a1 >> b) & 1) << 1)
            eq = [table[t][sym] for t in range(T)]
            s = [[0] * K for _ in range(T)]
            gen, prop = noise & other, (noise | noise >> 7) & other
            for t in range(T):
                c, ones = 0, U32
                for j in range(K):
                    x = (eq[t][j] & vp[t][j]) + vp[t][j] + c
                    s[t][j], c = x & U32, x >> 32
                    ones &= s[t][j]
                gen |= c << (gbase + t)
                prop |= int(c == 1 or ones == U32) << (gbase + t)
            cin = group_carries(gen, prop, gbase, T)
            d0 = [[0] * K for _ in range(T)]
            hp, hn = [[0] * K for _ in range(T)], [[0] * K for _ in range(T)]
            for t in range(T):
                c = cin[t]
                for j in range(K):
                    x = s[t][j] + c
                    c = x >> 32
                    v = vp[t][j]
                    d0[t][j] = ((x & U32) ^ v) | eq[t][j] | vn[t][j]
                    hp[t][j] = (vn[t][j] | ~(d0[t][j] | v)) & U32
                    hn[t][j] = v & d0[t][j]
            for t in range(T):
                hp_in = hp[t - 1][K - 1] >> 31 if t else 0
                hn_in = hn[t - 1][K - 1] >> 31 if t else 0
                for j in range(K):
                    x = ((hp[t][j] << 1) | hp_in) & U32
                    vp[t][j] = (((hn[t][j] << 1) | hn_in)
                                | ~(d0[t][j] | x)) & U32
                    vn[t][j] = d0[t][j] & x
                    hp_in, hn_in = hp[t][j] >> 31, hn[t][j] >> 31
            score += (hp[T - 1][K - 1] >> 31) - (hn[T - 1][K - 1] >> 31)
            best = min(best, score)
    return best


def lane_models(gp, gwords, L, orient, start, tab, row, lens_r, m, ncols, e,
                K=None):
    """group_lane_model over every lane, with the K of the build that takes
    this bucket (or the K given)."""
    K = kernels.wide_words(m // 32) if K is None else K
    tab_n = tab.numpy()
    return [group_lane_model(
        gp, gwords, L, int(orient[i]), int(start[i]),
        [int(x) for x in tab_n[row[i]]], int(lens_r[row[i]]), m, ncols, e, K)
        for i in range(len(orient))]


@pytest.mark.parametrize("m,e,n", [(96, 4, 600), (64, 2, 600), (32, 3, 600),
                                   (288, 4, 96), (512, 3, 64),
                                   (1024, 4, 40)])
def test_gathering_verify_ref_vs_jax_sequence(rng, m, e, n):
    Wd, ncols = m // 32, m + 2 * e
    Ww = -(-ncols // 32)
    assert kernels.verify_fused_gather_fits(m, ncols)
    gp, L, reads, lens_r, row, orient, start = lanes(rng, n, m, e)
    # the JAX compact path: window_planes, then hamming / PEQ / Myers
    wj = jv.window_planes(jnp.asarray(gp), jnp.asarray(orient, jnp.int32),
                          jnp.asarray(start.astype(np.uint32)), Ww, L)
    rj = tuple(p[row] for p in jv.pack_codes(jnp.asarray(reads)))
    lj = jv.length_mask(jnp.asarray(lens_r[row], jnp.int32), m)
    ham = jv.hamming(_shift_planes(wj, e, Wd), rj, lj)
    want = jnp.where(ham <= e, ham,
                     jv.myers(wj, _peq_from_planes(*rj, ~lj), ~lj, m, ncols))
    hams = np.asarray(ham)
    assert (hams <= e).any() and (hams > e).any()
    # the port: planes table + per-lane row, no plane tensor in between
    tab = torch.stack(tv.pack_codes(torch.from_numpy(reads)), dim=1).reshape(
        len(reads), 3 * Wd)
    args = (torch.from_numpy(gp.view(np.int32)), T(orient), T(start), tab,
            T(row), T(lens_r[row]), L, gp.shape[0] // 2, m, ncols, e)
    before = dict(kernels.LAUNCHES)
    got = kernels.verify_fused_gather(*args)
    assert got.dtype == torch.int32 and kernels.LAUNCHES == before
    same(got, want)
    same(kernels.verify_fused_gather_ref(*args), want)
    if Wd > 8:           # the kernel for these widths, lane by lane
        same(got, lane_models(gp, gp.shape[0] // 2, L, orient, start, tab,
                              row, lens_r, m, ncols, e))


def test_gathering_verify_ref_vs_pallas_interpret(rng):
    """Against the Pallas kernel itself in interpret mode, at the
    reference's own small ungated size, fed by the JAX window gather."""
    from bitmapperbs_tpu.ops.pallas_kernels import verify_fused_pallas
    m, e, n = 32, 2, 8
    ncols = m + 2 * e
    gp, L, reads, lens_r, row, orient, start = lanes(rng, n, m, e, n_rows=8)
    wj = jv.window_planes(jnp.asarray(gp), jnp.asarray(orient, jnp.int32),
                          jnp.asarray(start.astype(np.uint32)), 2, L)
    rj = tuple(p[row] for p in jv.pack_codes(jnp.asarray(reads)))
    lj = jv.length_mask(jnp.asarray(lens_r[row], jnp.int32), m)
    want = verify_fused_pallas(wj, rj, lj, m, ncols, e, interpret=True)
    tab = torch.stack(tv.pack_codes(torch.from_numpy(reads)), dim=1).reshape(
        len(reads), 3)
    same(kernels.verify_fused_gather(
        torch.from_numpy(gp.view(np.int32)), T(orient), T(start), tab, T(row),
        T(lens_r[row]), L, gp.shape[0] // 2, m, ncols, e), want)


def test_gathering_verify_widths_and_raises(rng):
    """The gathering entry is built for every bucket (1..32 read words) and
    a window of one word more.  Device mixes and wrong lane types raise."""
    assert kernels.verify_fused_gather_fits(96, 104)
    assert kernels.verify_fused_gather_fits(256, 264)
    for m in (288, 512, 1024):                               # 9..32 words
        assert kernels.verify_fused_gather_fits(m, m + 8)
    assert not kernels.verify_fused_gather_fits(1056, 1064)  # 33 words
    assert not kernels.verify_fused_gather_fits(96, 96)      # e = 0
    assert not kernels.verify_fused_gather_fits(96, 96 + 40)  # e = 20
    m, e = 96, 4
    gp, L, reads, lens_r, row, orient, start = lanes(rng, 32, m, e)
    tab = torch.stack(tv.pack_codes(torch.from_numpy(reads)), dim=1).reshape(
        len(reads), 9)
    g = torch.from_numpy(gp.view(np.int32))
    ok = [g, T(orient), T(start), tab, T(row), T(lens_r[row])]
    tail = (L, gp.shape[0] // 2, m, m + 2 * e, e)
    for i in (1, 2, 4, 5):
        bad = list(ok)
        bad[i] = bad[i].to(torch.int32)
        with pytest.raises(ValueError):
            kernels.verify_fused_gather(*bad, *tail)
    bad = list(ok)
    bad[0] = bad[0].to("meta")
    with pytest.raises(ValueError):
        kernels.verify_fused_gather(*bad, *tail)


def test_long_bucket_takes_the_planes_entry():
    """Reads over 256 bp (9 plane words) took the planes entry once; now
    the compact path hands every bucket to the gathering entry (one call),
    and the tuples still equal the JAX package's."""
    from bitmapperbs_tpu.config import AlignerConfig
    from bitmapperbs_tpu.index.build import build_index
    from bitmapperbs_tpu.index.device import upload_index as jupload
    from bitmapperbs_tpu.models import aligner as jal
    from bitmapperbs_tpu.utils.simulate import simulate_reads
    from bitmapperbs_tpu_torch.index.device import upload_index
    from bitmapperbs_tpu_torch.models import aligner as tal
    from bitmapperbs_tpu_torch.models.host import prepare_batch

    B, m = 12, 288
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=m,
                        batch_size=B)
    idx = build_index(random_genome_fasta(np.random.default_rng(41),
                                          contigs=(5000, 2000)))
    sims = simulate_reads(idx.genome, B, read_len=280, seed=42,
                          sub_rate=0.004, indel_rate=0.001)
    arr, lens = prepare_batch([s.codes for s in sims], m, B)
    calls = []
    saved = kernels.verify_fused_gather
    kernels.verify_fused_gather = \
        lambda *a, **k: calls.append("gather") or saved(*a, **k)
    try:
        got = tal.map_batch_device(upload_index(idx), cfg,
                                   torch.from_numpy(arr),
                                   torch.from_numpy(lens))
    finally:
        kernels.verify_fused_gather = saved
    assert calls == ["gather"]
    want = jal.map_batch_device(jupload(idx), cfg, jnp.asarray(arr),
                                jnp.asarray(lens))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      np.asarray(want[k]).astype(np.int64),
                                      err_msg=k)
    assert int((got["best_score"] < (1 << 20)).sum()) > B // 2


def inline_window(gp, gwords, L, orient, start, ww):
    """verify_fused_gather_kernel's inline fetch: raw rows wi .. wi + ww of
    the orientation's block through plane_row (WindowModel.row: a whole
    table or a list of shards), then the start & 31 funnel and the
    out-of-genome N marking, word by word.  Returns (b0, b1, nmask)."""
    w = WindowModel(gp, orient, start, gwords, L)
    raw = [w.row(w.wi + k) for k in range(ww + 1)]
    sh, words = start & 31, []
    for k in range(ww):
        a = raw[k] if not sh else [
            ((lo >> sh) | (hi << (32 - sh))) & U32
            for lo, hi in zip(raw[k], raw[k + 1])]
        ws = (start + 32 * k) & U32
        if ws >= 0xFFFFF000:
            oob = mask_lt(min((-ws) & U32, 32))
        elif ws >= L:
            oob = U32
        else:
            oob = ~mask_lt(min(L - ws, 32)) & U32
        words.append((a[0] & ~oob & U32, a[1] & ~oob & U32, a[2] | oob))
    return tuple(list(p) for p in zip(*words))


@pytest.mark.parametrize("ns", [2, 3])
@pytest.mark.parametrize("m,e,n", [(96, 4, 300), (288, 4, 64)])
def test_gathering_verify_on_a_shard_set(rng, ns, m, e, n):
    """verify_fused_gather on genome planes split over ns shards: the
    window words of the inline fetch model (narrow kernel) and the streamed
    one (wide kernel) read from the parts equal window_planes on the shard
    set and the JAX package's sharded window_planes under shard_map; the
    wrapper's result equals the whole table's and, lane by lane, the scalar
    model on the parts.  Lanes: both orientations, starts that wrap below 0,
    windows past the genome end, and the last window words of each block."""
    Wd, ncols = m // 32, m + 2 * e
    Ww = Wd + 1
    gp, L, reads, lens_r, row, orient, start = lanes(rng, n, m, e)
    gwords = gp.shape[0] // 2
    start[2:4] = (32 * gwords + rng.integers(0, 64, 2)) & U32   # past it
    parts, shards = split_planes(gp, ns)
    mesh = JMesh(np.array(jax.devices()[:ns]), ("idx",))
    padded = np.concatenate(parts)
    gj = jax.device_put(jnp.asarray(padded), NamedSharding(mesh, P("idx")))
    want_win = jax.jit(shard_map(
        lambda g, o, s: jv.window_planes(g, o, s, Ww, L, idx_axis="idx",
                                         g_words=gwords),
        mesh=mesh, in_specs=(P("idx"), P(), P()), out_specs=P(),
        check_vma=False))(gj, jnp.asarray(orient, jnp.int32),
                          jnp.asarray(start.astype(np.uint32)))
    plain_win = tv.window_planes(shards, T(orient), T(start), Ww, L, gwords)
    for p in range(3):
        same(plain_win[p], want_win[p], f"plain vs JAX sharded, plane {p}")
    for i in range(n):
        model = inline_window(parts, gwords, L, int(orient[i]),
                              int(start[i]), Ww)
        stream = WindowModel(parts, int(orient[i]), int(start[i]), gwords, L)
        streamed = [stream.next() for _ in range(Ww)]
        for p in range(3):
            assert model[p] == [w[p] for w in streamed], (i, p)
            same(plain_win[p][i], model[p], f"lane {i}, plane {p}")
    tab = torch.stack(tv.pack_codes(torch.from_numpy(reads)), dim=1).reshape(
        len(reads), 3 * Wd)
    lane_args = (T(orient), T(start), tab, T(row), T(lens_r[row]), L, gwords,
                 m, ncols, e)
    before = dict(kernels.LAUNCHES)
    got = kernels.verify_fused_gather(shards, *lane_args)
    assert kernels.LAUNCHES == before
    assert torch.equal(got, kernels.verify_fused_gather(
        torch.from_numpy(gp.view(np.int32)), *lane_args))
    if Wd > 8:
        same(got, lane_models(parts, gwords, L, orient, start, tab, row,
                              lens_r, m, ncols, e))
