"""PyTorch port, paired-end mate rescue as one kernel.

The CUDA kernel btbs_rescue_scan (csrc/verify.cu) cannot run without a card,
so three things are held here on the CPU, all with exact equality:

1. its plain version `kernels.rescue_scan_ref` (what the wrapper runs on CPU
   tensors) against the JAX package's map_batch_pe_device `resc_*` outputs,
   directional and PBAT, e 3 and 4;
2. a scalar per-lane model of the kernel's control flow (window words fetched
   as the columns advance, a pair's output columns split into chunks that each
   start fresh after a warm-up, the running (best, lowest position) and the
   one-byte thresholded scores, the u32 wraps) against the plain version, on
   random lanes and on planted edge lanes;
3. the lemma the chunks rest on: a scan started fresh at least m + e - 1
   columns before a column gives that column the full scan's score wherever
   either is <= e.

On a sharded index the kernel's SHARD instance reads each plane row from the
shard that holds it (WindowModel on a list of parts); 2 and 3 shards are held
to the plain version on the shard set and to the whole table's result.

The window and Myers-column models are shared with
tests/test_torch_verify_gather.py (the gathering verify for reads over
256 bp runs the same device code)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bitmapperbs_tpu.config import AlignerConfig  # noqa: E402
from bitmapperbs_tpu.index.build import build_index, parse_fasta  # noqa: E402
from bitmapperbs_tpu.index.device import upload_index as jupload  # noqa: E402
from bitmapperbs_tpu.models import paired as jpaired  # noqa: E402
from bitmapperbs_tpu.models.host import map_batch_pe_tpu  # noqa: E402
from bitmapperbs_tpu.utils.simulate import simulate_pairs  # noqa: E402
from bitmapperbs_tpu_torch import constants as K  # noqa: E402
from bitmapperbs_tpu_torch.index.device import (  # noqa: E402
    Shards, _device_layout_planes, upload_index)
from bitmapperbs_tpu_torch.models import paired as tpaired  # noqa: E402
from bitmapperbs_tpu_torch.models.host import (map_batch_pe as tmap_pe,  # noqa: E402
                                               prepare_batch)
from bitmapperbs_tpu_torch.ops import kernels  # noqa: E402
from bitmapperbs_tpu_torch.ops import verify as tv  # noqa: E402
from chip_smoke import straddling_pairs, tandem_genome_fasta  # noqa: E402

U32 = 0xFFFFFFFF
INF = K.INF_SCORE


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---- scalar models of the device code (one thread at a time) ---------------

def mask_lt(nb: int) -> int:
    return U32 if nb >= 32 else (1 << nb) - 1


def split_planes(gp, ns: int):
    """Genome planes uint32 [rows, 3] split as upload_index_sharded splits
    them (zero rows at the end to a multiple of ns): the parts as numpy (for
    the models) and as a Shards of int32 tensors (for the wrappers)."""
    gp = np.concatenate([gp, np.zeros((-len(gp) % ns, 3), gp.dtype)])
    parts = np.split(gp, ns)
    return parts, Shards(tuple(torch.from_numpy(p.view(np.int32).copy())
                               for p in parts))


MAX_SHARDS = 8                  # csrc/shards.cuh kMaxShards


def shard_first_rows(n: int, rows: int) -> list:
    """ShardSet.first (csrc/shards.cuh make_shard_set): part s's first row,
    s * rows, for s < n; 0xFFFFFFFF for the unused parts."""
    return [s * rows if s < n else U32 for s in range(MAX_SHARDS)]


def shard_pick(first, n: int, rows: int, r: int):
    """shard_row<W>'s choice for row r: (part, row within it), or None (the
    zero row) outside [0, n * rows).  The last part whose first row the u32
    row reaches, by compares over every part: no division."""
    if not 0 <= r < n * rows:
        return None
    u, s, lo = r & U32, 0, 0
    for k in range(1, MAX_SHARDS):
        if u >= first[k]:
            s, lo = k, first[k]
    return s, (u - lo) & U32


def shard_row_model(parts, r):
    """Row r of a list of equal parts as shard_row<W> reads it; None for
    the zero row."""
    n, rows = len(parts), len(parts[0])
    pick = shard_pick(shard_first_rows(n, rows), n, rows, r)
    return None if pick is None else parts[pick[0]][pick[1]]


class WindowModel:
    """csrc/verify.cu WindowReader: word k of the window at u32 `start`,
    fetched from the plane rows when asked for, the upper raw row kept as the
    next word's lower one.  gp: the whole planes, or a list of their parts
    (the SHARD instance)."""

    def __init__(self, gp, orient, start, gwords, genome_len, k0=0):
        self.gp, self.gwords, self.genome_len = gp, gwords, genome_len
        self.base = orient * gwords
        self.st, self.sh = start, start & 31
        self.wi = ((start + 32) & U32) >> 5          # u32 add: wraps below 0
        self.k = k0
        self.raw = self.row(self.wi + k0)

    def row(self, r):
        """plane_row: r clamped into the orientation's block, then clamped
        into a whole table, or a zero row outside every part of a shard
        set."""
        r = self.base + (self.gwords - 1 if r >= self.gwords else r)
        if isinstance(self.gp, list):
            row = shard_row_model(self.gp, r)
            return [0, 0, 0] if row is None else [int(x) for x in row]
        r = min(max(r, 0), 2 * self.gwords - 1)
        return [int(x) for x in self.gp[r]]

    def next(self):
        hi = self.row(self.wi + self.k + 1)
        a = list(self.raw)
        if self.sh:
            a = [((lo >> self.sh) | (h << (32 - self.sh))) & U32
                 for lo, h in zip(self.raw, hi)]
        ws = (self.st + 32 * self.k) & U32
        if ws >= 0xFFFFF000:                          # wrapped below 0
            oob = mask_lt(min((-ws) & U32, 32))
        elif ws >= self.genome_len:
            oob = U32
        else:
            oob = ~mask_lt(min(self.genome_len - ws, 32)) & U32
        self.raw = hi
        self.k += 1
        return a[0] & ~oob & U32, a[1] & ~oob & U32, a[2] | oob


def myers_column_words(vp, vn, eq):
    """One column of the multi-word recurrence on lists of u32 words, in
    place (csrc/verify.cu myers_column / myers_column_shared); returns the
    change of the last row's score."""
    carry = hp_prev = hn_prev = hp = hn = 0
    for k in range(len(vp)):
        v = vp[k]
        s = (eq[k] & v) + v + carry
        carry = s >> 32
        d0 = ((s & U32) ^ v) | eq[k] | vn[k]
        hp = (vn[k] | ~(d0 | v)) & U32
        hn = v & d0
        x = ((hp << 1) | (hp_prev >> 31)) & U32
        vp[k] = (((hn << 1) | (hn_prev >> 31)) | ~(d0 | x)) & U32
        vn[k] = d0 & x
        hp_prev, hn_prev = hp, hn
    return (hp >> 31) - (hn >> 31)


def eq_row(peq, pad, a0, a1, an, b):
    """The match row of window bit b: the pad row on an N column, else the
    PEQ row of the 2-bit code."""
    if (an >> b) & 1:
        return pad
    return peq[((a0 >> b) & 1) | (((a1 >> b) & 1) << 1)]


def rescue_pair_model(gp, gwords, L, blk, win_start, r_ok, a_lo, span, ms_len,
                      peq, pad, m, e, R, chunks, two_pass=False):
    """One pair as rescue_scan_kernel runs it with `chunks` threads, in one
    pass (MODE 0) or in two (MODE 1, then MODE 2): returns (rs_best,
    rp_best, rs_second, columns run)."""
    nout = 0
    if r_ok:
        span_i32 = span - (1 << 32) if span >= (1 << 31) else span
        if span_i32 >= 0:
            nout = min(span_i32, R + e) + 1
    ch = -(-nout // chunks)
    jo = e + m - 1
    cols_run = 0

    def scan(q0, q1):
        """One thread's columns: yields (q, score) for its output columns,
        after the warm-up."""
        nonlocal cols_run
        j_first = max(0, jo + q0 - (m + e))
        j_last = jo + q1 - 1
        win = WindowModel(gp, blk, win_start, gwords, L, j_first >> 5)
        vp, vn, score = [U32] * (m // 32), [0] * (m // 32), m
        for w in range(j_first >> 5, (j_last >> 5) + 1):
            a0, a1, an = win.next()
            for b in range(max(j_first - 32 * w, 0),
                           min(j_last - 32 * w, 31) + 1):
                score += myers_column_words(
                    vp, vn, eq_row(peq, pad, a0, a1, an, b))
                cols_run += 1
                q = 32 * w + b - jo
                if q >= q0:
                    yield q, score

    def frame(A):
        return A if blk == 0 else (L - A - ms_len) & U32

    splits = [(min(c * ch, nout), min(min(c * ch, nout) + ch, nout))
              for c in range(chunks)]
    threads = []                         # per thread: its running best, bytes
    for q0, q1 in splits:
        best, best_p, sc = INF, U32, {}
        if q0 < q1:
            for q, score in scan(q0, q1):
                if not two_pass:
                    sc[q] = min(score, e + 1)     # one byte per column
                if score <= e:
                    P = frame((a_lo + q) & U32)
                    if (score, P) < (best, best_p):
                        best, best_p = score, P
            assert two_pass or sorted(sc) == list(range(q0, q1))
        threads.append((q0, q1, best, best_p, sc))
    # the shuffle rounds: lexicographic minimum over the pair's threads
    best, best_p = min((t[2], t[3]) for t in threads)
    second = INF
    a_best = frame(best_p)                   # the frame map is its own inverse
    for q0, q1, _, _, sc in threads:
        if q0 < q1 and best <= e:
            # MODE 0 re-reads its own bytes; MODE 2 runs the scan again
            cols = sc.items() if not two_pass else scan(q0, q1)
            for q, s in cols:
                if s <= e and abs(((a_lo + q) & U32) - a_best) > e:
                    second = min(second, s)
    return best, best_p, second, cols_run


# ---- 2. the model against the plain version ---------------------------------

def toy_genome(rng, unit=9, copies=14, tail=0):
    """Two contigs, the first with a tandem repeat of a `unit`-bp word in
    its middle (several columns reach the same score there, a period
    apart) and `tail` more bases behind it (room for a wide window)."""
    def seq(n):
        return "".join(rng.choice(list("ACGT"), n))
    chr1 = seq(500) + seq(unit) * copies + seq(400 + tail)
    return parse_fasta(f">c1\n{chr1}\n>c2\n{seq(300)}\n")


def rescue_lanes(rng, n, m, e, R, genome):
    """n pairs' rescue inputs over the toy genome: the missing mate cut from
    inside the window of either block with bisulfite conversion and a few
    edits, plus planted edge lanes (the dict's `planted` names them)."""
    L = genome.length
    ref = np.stack([genome.codes, genome.rc_codes()])
    c1 = int(genome.offsets[0])              # contig 1: [c1, c1_end)
    c1_end = int(genome.offsets[1]) - c1
    rep0 = c1 + 500                          # the flank, then the repeat
    blk = rng.integers(0, 2, n)
    span = rng.integers(0, R, n)
    # most windows start inside contig 1 (in the lane's own orientation),
    # some anywhere: in the N padding, across contigs
    a_lo = np.where(blk == 0, c1, L - c1_end) \
        + rng.integers(0, c1_end - c1 - R - m, n)
    far = rng.random(n) < 0.15
    a_lo[far] = rng.integers(0, L - R - m, far.sum())
    r_ok = np.ones(n, bool)
    lens = np.where(rng.random(n) < 0.4, rng.integers(m // 2, m + 1, n), m)
    off = (rng.random(n) * (span + 1)).astype(np.int64)
    planted = {}

    def plant(i, name, **kw):
        planted[name] = i
        for k, v in kw.items():
            {"blk": blk, "span": span, "a_lo": a_lo, "r_ok": r_ok,
             "lens": lens, "off": off}[k][i] = v

    plant(0, "r_ok false", r_ok=False)
    plant(1, "r_ok false, garbage", r_ok=False, a_lo=U32 - 2, span=U32)
    plant(2, "span 0", blk=0, a_lo=c1 + 40, span=0, off=0)
    plant(3, "span R - 1", blk=0, a_lo=c1 + 50, span=R - 1, off=R - 1)
    plant(4, "a_lo < e", a_lo=e - 1, blk=0, span=R - 1, off=2)
    plant(5, "a_lo 0", a_lo=0, blk=1, span=5, off=0)
    plant(6, "block 1", blk=1, a_lo=L - c1_end + 30, span=R - 1, off=R // 2)
    plant(7, "past the end", a_lo=L - m - 3, span=R - 1, off=1)
    plant(8, "short mate", blk=0, a_lo=c1 + 60, lens=m // 2, span=R - 1,
          off=R // 3)
    plant(9, "repeat, block 0", blk=0, a_lo=rep0 - 4, span=R - 1, off=13,
          lens=m)
    plant(10, "repeat, block 1", blk=1, a_lo=L - rep0 - 120, span=R - 1,
          off=20, lens=m)
    plant(11, "span negative as int32", span=0x80000005)
    plant(12, "span past the window", blk=0, a_lo=c1 + 70, span=R + 3 * e,
          off=R + e)

    reads = np.full((n, m), K.N_CODE, np.uint8)
    for i in range(n):
        pos = a_lo[i] + off[i] + np.arange(lens[i] + e + 2)
        r = ref[blk[i], np.clip(pos, 0, L - 1)].copy()
        r[pos >= L] = K.N_CODE
        r[(r == K.C) & (rng.random(len(r)) < 0.7)] = K.T
        # planted lanes carry at most one edit (none inside the repeat)
        n_edits = int(rng.integers(0, e + 2)) if i >= len(planted) \
            else int(i < planted["repeat, block 0"])
        for _ in range(n_edits):
            p = int(rng.integers(0, lens[i]))
            op = rng.integers(0, 3)
            if op == 0:
                r[p] = rng.integers(0, 5)
            elif op == 1:
                r = np.delete(r, p)
            else:
                r = np.insert(r, p, rng.integers(0, 4))
        reads[i, :lens[i]] = r[:lens[i]]
    win_start = np.where(r_ok, (a_lo - e) & U32, 0)
    return {"blk": blk, "win_start": win_start, "r_ok": r_ok,
            "a_lo": a_lo & U32, "span": span & U32, "lens": lens,
            "reads": reads, "planted": planted}


def check_model(m, e, R, runs, n, seed, ns=0):
    """rescue_lanes' n pairs through the wrapper on the CPU (its plain
    version) and through the scalar model with each (threads per pair, two
    passes) of `runs`; returns the lanes and the plain outputs.  ns > 0:
    the genome planes split over ns shards (the SHARD instance), the
    outputs also equal to the whole table's."""
    rng = np.random.default_rng(seed)
    genome = toy_genome(rng, tail=R if R > 500 else 0)
    L = genome.length
    gp = _device_layout_planes(genome)
    gwords = gp.shape[0] // 2
    ln = rescue_lanes(rng, n, m, e, R, genome)
    peq, pad = tv.build_peq(torch.from_numpy(ln["reads"]), T(ln["lens"]), m)
    lanes = (T(ln["blk"]), T(ln["win_start"]), torch.from_numpy(ln["r_ok"]),
             T(ln["a_lo"]), T(ln["span"]), T(ln["lens"]), peq, pad, L,
             gwords, m, e, R)
    table = torch.from_numpy(gp.view(np.int32))
    if ns:
        whole = kernels.rescue_scan(table, *lanes)
        gp, table = split_planes(gp, ns)
    before = dict(kernels.LAUNCHES)
    rs, rp, r2 = kernels.rescue_scan(table, *lanes)
    assert kernels.LAUNCHES == before                  # plain version ran
    assert rs.dtype == r2.dtype == torch.int32 and rp.dtype == torch.int64
    if ns:
        for got, want in zip((rs, rp, r2), whole):
            assert torch.equal(got, want), "shard set vs whole table"
    rs, rp, r2 = rs.numpy(), rp.numpy(), r2.numpy()
    peq_n, pad_n = peq.numpy(), pad.numpy()
    for C, two_pass in runs:
        for i in range(n):
            got = rescue_pair_model(
                gp, gwords, L, int(ln["blk"][i]), int(ln["win_start"][i]),
                bool(ln["r_ok"][i]), int(ln["a_lo"][i]), int(ln["span"][i]),
                int(ln["lens"][i]), [[int(x) for x in row]
                                     for row in peq_n[i]],
                [int(x) for x in pad_n[i]], m, e, R, C, two_pass)
            assert got[:3] == (rs[i], rp[i], r2[i]), (C, two_pass, i, got)
    # the planted lanes are what their names say
    pl = ln["planted"]
    for name in ("r_ok false", "r_ok false, garbage",
                 "span negative as int32"):
        i = pl[name]
        assert (rs[i], rp[i], r2[i]) == (INF, U32, INF), name
    for name in ("span 0", "span R - 1", "block 1", "short mate",
                 "span past the window"):
        assert rs[pl[name]] <= e, name
    # equal minima a repeat period (> e) apart: the second best is as good
    # as the best, and the position is the lowest P (the last column on
    # block 1)
    for name in ("repeat, block 0", "repeat, block 1"):
        i = pl[name]
        assert rs[i] == r2[i] == 0, (name, rs[i], r2[i])
    return ln, rs, rp, r2


@pytest.mark.parametrize("m,e,R,chunks,n", [
    (32, 3, 61, (1, 2, 8, 32), 72),
    (64, 4, 101, (1, 4, 16), 72),
    (96, 2, 40, (8,), 72),
    # the default insert range of the command line, and one so wide that
    # the wrapper's rule takes 16 threads per pair
    (32, 3, 1_001, None, 32),
    (32, 3, 20_000, None, 14),
])
def test_kernel_model_matches_plain(m, e, R, chunks, n):
    if chunks is None:
        chunks = (kernels.rescue_scan_chunks(m, e, R),)
        assert chunks == (((8,) if R < 10_000 else (16,)) + (False,),)
    else:
        chunks = [(C, False) for C in chunks]
    _, rs, _, r2 = check_model(m, e, R, chunks, n, seed=100 + m)
    assert (rs < INF).sum() > n // 2 and (r2 < INF).any()
    # somewhere a hit has only neighbours within e: no second
    assert ((rs <= e) & (r2 == INF)).any()


@pytest.mark.parametrize("ns", [2, 3])
def test_shard_model_matches_plain(ns):
    """The SHARD instance on genome planes split over 2 and 3 shards: the
    scalar model, one pass (8 threads per pair) and two passes (32), equals
    the plain version on the shard set, which equals the whole table's,
    on every planted lane (wrapped window starts, windows past the genome
    end, both blocks)."""
    ln, rs, _, r2 = check_model(32, 3, 61, [(8, False), (32, True)], 72,
                                seed=300 + ns, ns=ns)
    assert (rs <= 3).sum() > 36 and (r2 <= 3).any()
    assert (ln["win_start"] >= 0xFFFFF000).any()


@pytest.mark.parametrize("m,e,R,chunks,n", [
    # the two-pass mode on many lanes of a narrow window (the mode does not
    # depend on the range; the wrapper takes it only past the bytes' limit)
    (32, 3, 61, (1, 8, 32), 72),
    (64, 4, 101, (4, 32), 40),
    # past the one-pass limit, where the wrapper takes it: few pairs, the
    # planted ones carrying the whole window
    (32, 3, 100_000, None, 14),
])
def test_two_pass_model_matches_plain(m, e, R, chunks, n):
    """The two-pass mode (MODE 1: best and its lowest position; MODE 2: the
    scan again for the best score more than e anchors away) equals the plain
    version, ties a period apart on both blocks and seconds included."""
    if chunks is None:
        runs = [kernels.rescue_scan_chunks(m, e, R)]
        assert runs == [(32, True)]
    else:
        runs = [(C, True) for C in chunks]
    ln, rs, rp, r2 = check_model(m, e, R, runs, n, seed=200 + m)
    assert (rs <= e).sum() > n // 2 and ((rs <= e) & (r2 == INF)).any()
    # a hit at the far end of a window wider than the one-pass limit
    assert rs[ln["planted"]["span R - 1"]] <= e


def test_rescue_scan_wrapper_raises_and_picks_chunks():
    # 8 threads per pair; more only where a block's bytes per output column
    # (and, over 256 bp, its PEQ table) would pass 227 KB of shared memory
    for m, e, R, want in ((96, 4, 501, 8), (96, 4, 1_001, 8),
                          (1_024, 4, 1_001, 8), (96, 4, 14_000, 8),
                          (96, 4, 20_000, 16), (96, 4, 40_000, 32),
                          (1_024, 4, 9_000, 8), (1_024, 4, 12_000, 16),
                          (1_024, 4, 30_000, 32)):
        assert kernels.rescue_scan_chunks(m, e, R) == (want, False), (m, e, R)
        table = 0 if m <= 256 else 5 * 4 * 128 * 32
        assert table + 128 // want * ((R + e + 4) & ~3) <= 227 * 1024
    # past what 32 threads per pair fit: the two passes, no limit
    for m, R in ((96, 60_000), (1_024, 40_000)):
        assert kernels.rescue_scan_chunks(m, 4, R) == (32, True), (m, R)
    rng = np.random.default_rng(5)
    genome = toy_genome(rng)
    gp = torch.from_numpy(_device_layout_planes(genome).view(np.int32))
    m, e, R, n = 32, 3, 20, 4
    ln = rescue_lanes(rng, 16, m, e, R, genome)
    peq, pad = tv.build_peq(torch.from_numpy(ln["reads"]), T(ln["lens"]), m)
    ok = [gp, T(ln["blk"]), T(ln["win_start"]), torch.from_numpy(ln["r_ok"]),
          T(ln["a_lo"]), T(ln["span"]), T(ln["lens"]), peq, pad]
    tail = (genome.length, gp.shape[0] // 2, m, e, R)
    kernels.rescue_scan(*ok, *tail)
    for i in (1, 2, 4, 5, 6, 7, 8):                   # int64 lanes and tables
        bad = list(ok)
        bad[i] = bad[i].to(torch.int32)
        with pytest.raises(ValueError):
            kernels.rescue_scan(*bad, *tail)
    bad = list(ok)
    bad[3] = bad[3].to(torch.int64)                   # r_ok is bool
    with pytest.raises(ValueError):
        kernels.rescue_scan(*bad, *tail)
    bad = list(ok)
    bad[0] = bad[0].to("meta")                        # no silent path
    with pytest.raises(ValueError):
        kernels.rescue_scan(*bad, *tail)


@pytest.mark.parametrize("m,one_pass_max", [(96, 58_107), (288, 50_427),
                                            (1_024, 37_627)])
def test_two_pass_dispatch_boundary(m, one_pass_max):
    """The largest insert range whose bytes per output column still fit a
    block of 4 pairs (32 threads each) keeps the one-pass mode; one offset
    more takes the two passes, at any range the kernel accepts."""
    e = 4
    assert kernels.rescue_scan_chunks(m, e, one_pass_max) == (32, False)
    table = 0 if m <= 256 else 5 * 4 * 128 * (12 if m <= 384 else 32)
    assert table + 4 * ((one_pass_max + e + 4) & ~3) <= 227 * 1024
    assert table + 4 * ((one_pass_max + 1 + e + 4) & ~3) > 227 * 1024
    for R in (one_pass_max + 1, 100_000, 1 << 24):
        assert kernels.rescue_scan_chunks(m, e, R) == (32, True), R


# ---- 3. the lemma ------------------------------------------------------------

@pytest.mark.parametrize("m,e,seed", [(32, 3, 0), (32, 0, 1), (64, 4, 2),
                                      (96, 4, 3)])
def test_fresh_start_lemma(m, e, seed):
    """Random texts with N columns and planted (edited, short) copies of the
    pattern: a scan started fresh at column s equals the full scan, clipped
    at e + 1, from column s + m + e - 1 on, and is never below it."""
    rng = np.random.default_rng(seed)
    n, ncols = 24, 4 * m + 40
    lens = np.where(rng.random(n) < 0.5, rng.integers(m // 2, m + 1, n), m)
    pats = np.full((n, m), K.N_CODE, np.uint8)
    text = rng.integers(0, 4, (n, ncols)).astype(np.uint8)
    text[rng.random(text.shape) < 0.03] = K.N_CODE
    for i in range(n):
        p = rng.integers(0, 4, lens[i]).astype(np.uint8)
        pats[i, :lens[i]] = p
        for at in rng.integers(0, ncols - m, 3):     # copies with edits
            c = p.copy()
            for _ in range(int(rng.integers(0, e + 2))):
                k = int(rng.integers(0, len(c)))
                op = rng.integers(0, 3)
                if op == 0:
                    c[k] = rng.integers(0, 4)
                elif op == 1:
                    c = np.delete(c, k)
                else:
                    c = np.insert(c, k, rng.integers(0, 4))
            text[i, at:at + len(c)] = c[:ncols - at]
    peq, pad = tv.build_peq(torch.from_numpy(pats), T(lens), m)

    def scan(codes):
        width = -(-codes.shape[1] // 32) * 32
        padded = np.full((n, width), K.N_CODE, np.uint8)
        padded[:, :codes.shape[1]] = codes
        return tv.myers_scan(tv.pack_codes(torch.from_numpy(padded)), peq,
                             pad, m, codes.shape[1]).numpy()

    full = scan(text)
    assert (full <= e).any() and (full > e).any()
    warm = m + e - 1
    for s in (1, 7, 32, m + 5, 2 * m + 11):
        fresh = scan(text[:, s:])                    # column j of it is s + j
        assert (fresh >= full[:, s:]).all()
        np.testing.assert_array_equal(
            np.minimum(fresh[:, warm:], e + 1),
            np.minimum(full[:, s + warm:], e + 1))
    # and the warm-up is needed: without it some column differs
    assert (np.minimum(scan(text[:, 32:]), e + 1)
            != np.minimum(full[:, 32:], e + 1)).any()


# ---- 1. the plain version against the JAX package ----------------------------

@pytest.fixture(scope="module")
def repeat_setup():
    idx = build_index(tandem_genome_fasta(31))
    pairs = straddling_pairs(idx, 24, seed=32) + [
        (a.codes, b.codes) for a, b in simulate_pairs(
            idx.genome, 8, read_len=80, seed=5, min_insert=150,
            max_insert=260, sub_rate=0.01, indel_rate=0.01)]
    pairs[3] = (pairs[3][0][:50], pairs[3][1][:64])   # short mates
    return idx, jupload(idx), upload_index(idx), pairs


@pytest.mark.parametrize("e,pbat", [(3, False), (4, False), (3, True),
                                    (4, True)])
def test_plain_version_matches_jax_rescue(repeat_setup, e, pbat):
    idx, jd, td, pairs = repeat_setup
    cfg = AlignerConfig(max_errors=e, indels=True, paired=True,
                        min_insert=100 if pbat else 120,
                        max_insert=450 if pbat else 280, read_len_bucket=96,
                        batch_size=len(pairs), non_directional=pbat,
                        use_pallas=False)
    a1, l1 = prepare_batch([p[0] for p in pairs], 96, len(pairs))
    a2, l2 = prepare_batch([p[1] for p in pairs], 96, len(pairs))
    want = jpaired.map_batch_pe_device(jd, cfg, jnp.asarray(a1),
                                       jnp.asarray(l1), jnp.asarray(a2),
                                       jnp.asarray(l2))
    calls = []
    saved = kernels.rescue_scan
    kernels.rescue_scan = lambda *a: calls.append(a) or saved(*a)
    try:
        got = tpaired.map_batch_pe_device(
            td, cfg, torch.from_numpy(a1), torch.from_numpy(l1),
            torch.from_numpy(a2), torch.from_numpy(l2))
    finally:
        kernels.rescue_scan = saved
    assert len(calls) == 1                            # one call per batch
    ref = kernels.rescue_scan_ref(*calls[0])
    for key, plain in zip(("resc_score", "resc_fwd", "resc_second"), ref):
        w = np.asarray(want[key]).astype(np.int64)
        np.testing.assert_array_equal(plain.numpy().astype(np.int64), w,
                                      err_msg=key)
        np.testing.assert_array_equal(got[key].numpy().astype(np.int64), w,
                                      err_msg=key)
    np.testing.assert_array_equal(got["resc_valid"].numpy(),
                                  np.asarray(want["resc_valid"]))
    decided = got["resc_valid"].numpy() & ~got["pair_valid"].numpy()
    assert decided[:24].sum() >= 12                   # rescue decides here
    assert (np.asarray(want["resc_second"]) < INF).any()


def test_wide_insert_pe_matches_jax(repeat_setup, monkeypatch):
    """Insert range 0-100,000, past what the one-pass kernel fits at any
    read length (the wrapper takes the two passes there): the port's
    map_batch_pe on the CPU writes the JAX package's SAM, and rescue decides
    pairs across the whole small genome."""
    from bitmapperbs_tpu_torch.models import host as thost

    idx, jd, td, pairs = repeat_setup
    pairs = pairs[:16]
    cfg = AlignerConfig(max_errors=4, indels=True, paired=True, min_insert=0,
                        max_insert=100_000, read_len_bucket=96,
                        batch_size=len(pairs), use_pallas=False)
    assert kernels.rescue_scan_chunks(96, 4, 100_001) == (32, True)
    outs = []
    run = thost.map_batch_pe_device
    monkeypatch.setattr(thost, "map_batch_pe_device",
                        lambda *a, **k: outs.append(run(*a, **k)) or outs[-1])
    got = [r.line() for r in tmap_pe(idx, td, cfg, pairs)]
    assert got == [r.line() for r in map_batch_pe_tpu(idx, jd, cfg, pairs)]
    out = outs[0]
    decided = out["resc_valid"].numpy() & ~out["pair_valid"].numpy()
    assert decided.sum() >= 4
