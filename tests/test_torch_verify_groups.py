"""PyTorch port: the thread-group design of the wide gathering verify
(csrc/verify.cu verify_fused_gather_wide_kernel, 9..32 read words) and the
division-free shard fetch (csrc/shards.cuh shard_row).

The CUDA kernel runs a lane on a group of T threads, each holding a few words
of the Myers state, and passes a column's add carry across the group by
carry lookahead on the threads' generate / propagate ballots.  A scalar model
of it (test_torch_verify_gather.group_lane_model: per-thread words, the
masks, the masked add, the shuffled top bits, the Hamming split) is held to
the port's plain version and to the JAX package's compact-path sequence (and,
at a small width, its Pallas kernel in interpret mode) at every group width
the dispatch picks and at the others; the carry identity itself is checked
against the serial chain on random words, several groups to a warp; and the
shard choice by compares against the division it replaces, at the parts'
boundaries."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bitmapperbs_tpu.models.aligner import (_peq_from_planes,  # noqa: E402
                                            _shift_planes)
from bitmapperbs_tpu.ops import verify as jv  # noqa: E402
from bitmapperbs_tpu_torch.ops import kernels  # noqa: E402
from bitmapperbs_tpu_torch.ops import verify as tv  # noqa: E402
from test_torch_rescue_scan import (MAX_SHARDS, shard_first_rows,  # noqa: E402
                                    shard_pick, split_planes)
from test_torch_verify_gather import (WIDE_CAPACITIES, T,  # noqa: E402
                                      group_carries, group_lane_model,
                                      lane_models, lanes, same, wide_builds,
                                      wide_capacity)

U32 = 0xFFFFFFFF


def jax_compact(gp, L, reads, lens_r, row, orient, start, m, e):
    """The JAX package's compact path on these lanes: window_planes, then
    Hamming of the e-shifted window, PEQ and Myers, and the select."""
    Wd, ncols = m // 32, m + 2 * e
    wj = jv.window_planes(jnp.asarray(gp), jnp.asarray(orient, jnp.int32),
                          jnp.asarray(start.astype(np.uint32)),
                          -(-ncols // 32), L)
    rj = tuple(p[row] for p in jv.pack_codes(jnp.asarray(reads)))
    lj = jv.length_mask(jnp.asarray(lens_r[row], jnp.int32), m)
    ham = jv.hamming(_shift_planes(wj, e, Wd), rj, lj)
    return np.asarray(jnp.where(
        ham <= e, ham, jv.myers(wj, _peq_from_planes(*rj, ~lj), ~lj, m,
                                ncols)))


def read_table(reads, Wd):
    return torch.stack(tv.pack_codes(torch.from_numpy(reads)), dim=1).reshape(
        len(reads), 3 * Wd)


def test_dispatch_words():
    """Every bucket's words per thread is one the kernel is built for and
    holds a lane of any of its word counts on at most one warp, and every
    bucket of 9..32 words goes to the smallest capacity that holds it: at
    the 288 bucket (9 words) a lane on 2 threads of 5 words."""
    builds = wide_builds()
    assert builds == [4, 5, 6, 8]
    assert set(WIDE_CAPACITIES) == {12, 16, 24, 32}
    assert all(kernels.wide_words(nw) in builds for nw in WIDE_CAPACITIES)
    assert all(-(-32 // k) <= 32 for k in builds)   # any build, any bucket
    assert [wide_capacity(w) for w in (9, 12, 13, 16, 17, 24, 25, 32)] == \
        [12, 12, 16, 16, 24, 24, 32, 32]
    assert [kernels.wide_words(w) for w in (9, 13, 17, 25)] == [5, 4, 6, 8]
    assert -(-9 // kernels.wide_words(9)) == 2


@pytest.mark.parametrize("m,e,n", [(288, 0, 48), (288, 4, 64), (288, 15, 48),
                                   (512, 0, 24), (512, 4, 32), (512, 15, 24),
                                   (768, 4, 16), (1024, 0, 24),
                                   (1024, 4, 16), (1024, 15, 32)])
def test_group_model_vs_plain_and_jax(rng, m, e, n):
    """The kernel's model at every build's words per thread (the bucket's
    own first) equals the plain version and the JAX compact path: reads
    shorter than the bucket (pad rows, lengths off the 32-bit words),
    windows that wrap below 0 or run past the genome end (N columns), both
    orientations, ham <= e and ham > e lanes.  e = 0 is the model alone: the entry takes a window one
    word longer than the read, which e = 0 does not give."""
    Wd, ncols = m // 32, m + 2 * e
    gp, L, reads, lens_r, row, orient, start = lanes(rng, n, m, e, n_rows=16)
    want = jax_compact(gp, L, reads, lens_r, row, orient, start, m, e)
    assert (want <= e).any() and (want > e).any()
    assert (lens_r[row] % 32 != 0).any() and (lens_r[row] < m).any()
    tab = read_table(reads, Wd)
    args = (torch.from_numpy(gp.view(np.int32)), T(orient), T(start), tab,
            T(row), T(lens_r[row]), L, gp.shape[0] // 2, m, ncols, e)
    same(kernels.verify_fused_gather_ref(*args), want)
    assert kernels.verify_fused_gather_fits(m, ncols) == (e > 0)
    own = kernels.wide_words(Wd)
    for k in [own] + [k for k in wide_builds() if k != own]:
        same(torch.tensor(lane_models(gp, gp.shape[0] // 2, L, orient, start,
                                      tab, row, lens_r, m, ncols, e, k)),
             want, f"K {k}")


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 8, 12, 16])
def test_group_model_every_width(rng, k):
    """Any words per thread, so any group width: at the 288 bucket (9 words:
    9 down to 2 threads, words below 0 in thread 0 wherever K does not
    divide 9) and at 1,024 (32 words: 32 down to 4 threads), the group
    placed anywhere in its warp beside other groups' ballot bits."""
    for m, n in ((288, 24), (1024, 6)):
        e = 4
        Wd, ncols = m // 32, m + 2 * e
        gp, L, reads, lens_r, row, orient, start = lanes(rng, n, m, e)
        want = jax_compact(gp, L, reads, lens_r, row, orient, start, m, e)
        tab = read_table(reads, Wd).numpy()
        group = -(-Wd // k)
        for i in range(n):
            gbase = group * int(rng.integers(0, 32 // group))
            got = group_lane_model(
                gp, gp.shape[0] // 2, L, int(orient[i]), int(start[i]),
                [int(x) for x in tab[row[i]]], int(lens_r[row[i]]), m, ncols,
                e, k, gbase=gbase, noise=int(rng.integers(0, 1 << 32)))
            assert got == want[i], (m, i, got, want[i])


@pytest.mark.parametrize("ns", [2, 3])
@pytest.mark.parametrize("m,e,n", [(288, 4, 48), (1024, 15, 8)])
def test_group_model_on_a_shard_set(rng, ns, m, e, n):
    """The SHARD instance: window words read from the part that holds each
    row (a zero row past the parts) through the compare-based shard pick;
    the model on the parts equals the plain version on the shard set and on
    the whole table."""
    Wd, ncols = m // 32, m + 2 * e
    gp, L, reads, lens_r, row, orient, start = lanes(rng, n, m, e)
    gwords = gp.shape[0] // 2
    start[2:4] = (32 * gwords + rng.integers(0, 64, 2)) & U32   # past it
    parts, shards = split_planes(gp, ns)
    tab = read_table(reads, Wd)
    lane_args = (T(orient), T(start), tab, T(row), T(lens_r[row]), L, gwords,
                 m, ncols, e)
    want = kernels.verify_fused_gather_ref(shards, *lane_args)
    assert torch.equal(want, kernels.verify_fused_gather_ref(
        torch.from_numpy(gp.view(np.int32)), *lane_args))
    same(want, lane_models(parts, gwords, L, orient, start, tab, row, lens_r,
                           m, ncols, e))


def test_group_model_vs_pallas_interpret(rng):
    """Against the Pallas kernel in interpret mode, at a width it runs in
    seconds (1 read word: a group of one thread), fed by the JAX window
    gather."""
    from bitmapperbs_tpu.ops.pallas_kernels import verify_fused_pallas
    m, e, n = 32, 2, 8
    Wd, ncols = m // 32, m + 2 * e
    gp, L, reads, lens_r, row, orient, start = lanes(rng, n, m, e, n_rows=8)
    wj = jv.window_planes(jnp.asarray(gp), jnp.asarray(orient, jnp.int32),
                          jnp.asarray(start.astype(np.uint32)), Wd + 1, L)
    rj = tuple(p[row] for p in jv.pack_codes(jnp.asarray(reads)))
    lj = jv.length_mask(jnp.asarray(lens_r[row], jnp.int32), m)
    want = np.asarray(verify_fused_pallas(wj, rj, lj, m, ncols, e,
                                          interpret=True))
    tab = read_table(reads, Wd).numpy()
    got = [group_lane_model(gp, gp.shape[0] // 2, L, int(orient[i]),
                            int(start[i]), [int(x) for x in tab[row[i]]],
                            int(lens_r[row[i]]), m, ncols, e, 1)
           for i in range(n)]
    same(torch.tensor(got), want)


def chain_words(rng, n: int) -> tuple:
    """n word pairs (eq, vp) of a column's add (eq & vp) + vp: random ones,
    words whose sum is all ones (propagate: vp all ones, eq zero, the only
    way) and words that surely carry out (generate: bit 31 set in both), so
    that long carry chains occur."""
    vp = rng.integers(0, 1 << 32, n, dtype=np.int64)
    eq = rng.integers(0, 1 << 32, n, dtype=np.int64)
    kind = rng.integers(0, 4, n)
    vp[kind == 1], eq[kind == 1] = U32, 0
    vp[kind == 2] |= 1 << 31
    eq[kind == 2] |= 1 << 31
    return eq, vp


@settings(max_examples=150, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), group=st.integers(1, 32),
       k=st.integers(1, 4))
def test_carry_lookahead_matches_the_serial_chain(seed, group, k):
    """The carry identity on a whole warp of floor(32 / T) groups (the
    spare threads' bits random above them): every thread
    adds its K words with carry in 0, the warp ballots g and g | p, each
    thread's masked add gives the carry into its first word, equal to the
    serial add-with-carry chain's over the group's T K words, and the words
    the thread gets by adding it in equal the chain's words."""
    rng = np.random.default_rng(seed)
    eq, vp = chain_words(rng, 32 * k)
    eq, vp = eq.reshape(32, k), vp.reshape(32, k)
    # per thread: the sum with carry in 0, its carry out and all-ones
    s0, gen, prop = np.zeros((32, k), np.int64), 0, 0
    for lane in range(32):
        c, ones = 0, U32
        for j in range(k):
            x = (int(eq[lane, j]) & int(vp[lane, j])) + int(vp[lane, j]) + c
            s0[lane, j], c = x & U32, x >> 32
            ones &= int(s0[lane, j])
        gen |= c << lane
        prop |= int(c == 1 or ones == U32) << lane
    for gbase in range(0, 32 // group * group, group):
        cin = group_carries(gen, prop, gbase, group)
        c_serial = 0
        for t in range(group):
            lane = gbase + t
            assert cin[t] == c_serial, (gbase, t)
            c = cin[t]
            for j in range(k):
                x = int(s0[lane, j]) + c
                c = x >> 32
                want = (int(eq[lane, j]) & int(vp[lane, j])) \
                    + int(vp[lane, j]) + c_serial
                assert x & U32 == want & U32, (gbase, t, j)
                c_serial = want >> 32


def test_carry_lookahead_long_chains():
    """A carry generated at the group's first word runs through every
    all-ones word above it, and stops at the group's edge: the next group
    of the warp gets no carry from it."""
    for group in (3, 4, 8, 11, 16, 32):
        for start in range(group):
            gen = 1 << start
            prop = ((1 << group) - 1) & ~((1 << start) - 1)   # all above: p
            for g in range(32 // group):
                low = (1 << (g * group)) - 1             # every group below
                cin = group_carries((gen << (g * group)) | low,
                                    (prop << (g * group)) | low, g * group,
                                    group)
                assert cin == [int(t > start) for t in range(group)]
        assert group_carries(U32, U32, 0, group)[0] == 0


@pytest.mark.parametrize("n", range(1, MAX_SHARDS + 1))
def test_shard_pick_without_division(n):
    """shard_row's part choice by compares against each part's first row
    equals r // rows, r % rows at the boundaries k rows - 1 and k rows, at
    small tables and at rows near 2^32 / n (n rows < 2^32, checked where
    the set is made); outside [0, n rows) it is the zero row."""
    for rows in sorted({1, 2, 3, 1_000, 81_920, U32 // n - 1, U32 // n}):
        assert n * rows <= U32
        first = shard_first_rows(n, rows)
        assert first[:n] == [s * rows for s in range(n)]
        assert all(f == U32 for f in first[n:])
        probe = {0, n * rows - 1}
        for k in range(1, n + 1):
            probe |= {k * rows - 1, k * rows, k * rows + 1}
        for r in sorted(probe):
            if r < n * rows:
                assert shard_pick(first, n, rows, r) == divmod(r, rows), \
                    (n, rows, r)
            else:
                assert shard_pick(first, n, rows, r) is None
        assert shard_pick(first, n, rows, -1) is None
