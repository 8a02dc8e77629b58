"""FM-index lane ops (counterpart of bitmapperbs_tpu/ops/fm.py): occ/rank,
backward search with the k-mer lookup table, adaptive seed extension,
bounded-LF locate.

Every op is elementwise over an arbitrary lane shape with no host sync.
Positions and counts are u32 lanes carried as int64 (ops/u32.py).

The three step loops run as ONE kernel launch each on the card, every lane
in its own loop (ops/kernels.py, csrc/fm.cu): `search_patterns` ->
kernels.fm_search (after the k-mer table lookup, which stays a
kernels.gather_rows call), `extend_seeds` -> kernels.fm_extend, `locate` ->
kernels.fm_locate (LF walk and SA-sample lookup).  Their plain versions are
the lockstep loops below (`search_lockstep`, `extend_lockstep`,
`locate_lockstep`): masked steps over all lanes with no data-dependent
control flow, each checkpoint row, SA sample and k-mer table row one row
gather of int32 bits widened right after, the row index clamped into the
table as the reference's gathers clamp.  The wrappers run them on CPU
tensors, and the kernels are held to them.  Where the reference used
where-chains to dodge its device's gather costs on SMALL tables (cbase, n),
plain indexing gives the same values.

On a sharded index (index/device.upload_index_sharded) the same three
kernels launch once each: their SHARD instances read every checkpoint row
and SA sample from the shard that holds it, a zero row past the table (the
reference's sharded fetch, clip + where + psum).  The lockstep loops read a
sharded table through kernels.gather_table (one gather per shard, the
partial rows summed on the lanes' device), so they stay the plain versions
there too.
"""
from __future__ import annotations

import torch

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.index.device import DeviceIndex, Shards
from bitmapperbs_tpu_torch.ops import kernels   # mutual import: used in calls
from bitmapperbs_tpu_torch.ops.u32 import (MASK, bnot, mask_lt, popcount,
                                           widen, wrap)

_A = K.CONV_ALPHA
_W = K.CP_WORDS


def _lower_mask(within):
    """u32 lanes -> [..., _W] per-word masks of bits < within."""
    ar = torch.arange(_W, dtype=torch.int64, device=within.device) * 32
    return mask_lt(within[..., None] - ar)


def _popcount_sum(words):
    return popcount(words).sum(dim=-1)


def fetch_cp_rows(dix: DeviceIndex, row):
    """Checkpoint rows by flat row index, widened to u32 lanes.  Rows are
    clamped into a whole table, as the reference's gathers clamp; past a
    sharded one they are zero, as the reference's sharded fetch gives."""
    return widen(kernels.gather_table(dix.cp_rows, row.contiguous()))


def fetch_sa_samples(dix: DeviceIndex, flat_idx):
    sa = dix.sa_samples
    col = Shards(tuple(p[:, None] for p in sa.parts)) \
        if isinstance(sa, Shards) else sa[:, None]
    flat_idx = flat_idx.clamp(max=2 * dix.samples_max - 1)
    return widen(kernels.gather_table(col, flat_idx.contiguous())[..., 0])


def block_n(dix: DeviceIndex, block):
    return dix.n[block.to(torch.int64)]


def _cbase(dix: DeviceIndex, block, c):
    return dix.cbase.reshape(-1)[block.to(torch.int64) * _A + c]


def _pick(words, w):
    """words[..., w] for per-lane w."""
    return torch.gather(words, -1, w[..., None])[..., 0]


def occ(dix: DeviceIndex, block, c, i):
    """# occurrences of symbol c in BWT_block[0:i).  Lanes of (block, c, i)."""
    row = i // K.CP_BLOCK + block.to(torch.int64) * dix.rows_max
    within = i % K.CP_BLOCK
    rows = fetch_cp_rows(dix, row)
    base = _pick(rows[..., :_A], c)
    p0 = rows[..., _A:_A + _W]
    p1 = rows[..., _A + _W:_A + 2 * _W]
    b0 = ((0 - (c & 1)) & MASK)[..., None]
    b1 = ((0 - ((c >> 1) & 1)) & MASK)[..., None]
    ind = bnot(p0 ^ b0) & bnot(p1 ^ b1)
    return base + _popcount_sum(ind & _lower_mask(within))


def extend_backward(dix: DeviceIndex, block, sp, ep, c):
    """One backward-search step per lane; empty intervals stay empty."""
    cb = _cbase(dix, block, c)
    both = occ(dix, torch.stack([block, block]), torch.stack([c, c]),
               torch.stack([sp, ep]))
    return cb + both[0], cb + both[1]


def locate(dix: DeviceIndex, block, i, valid, n_lanes=None):
    """SA_block[i] per lane via <= dix.sa_rate LF steps; invalid lanes walk
    garbage safely; lanes at or past the count n_lanes (int64 [1] on the
    device, or None) give 0.  Returns u32 lanes.  One kernel on the card."""
    return kernels.fm_locate(dix, block, i, valid, n_lanes=n_lanes)


def locate_lockstep(dix: DeviceIndex, block, i, valid):
    """`locate`, lockstep over lanes.  Each step is one checkpoint-row
    gather (occ counts, BWT planes and SA-mark bits share the row); the
    SA-sample lookup happens once after the loop."""
    blk = block.to(torch.int64)
    nmax = block_n(dix, blk)
    cur = torch.minimum(torch.where(valid, i, 0), nmax - 1)
    steps = torch.zeros_like(cur)
    rank = torch.zeros_like(cur)
    done = torch.zeros(cur.shape, dtype=torch.bool, device=cur.device)
    for _ in range(dix.sa_rate):
        rows = fetch_cp_rows(dix, cur // K.CP_BLOCK + blk * dix.rows_max)
        within = cur % K.CP_BLOCK
        w = within // 32
        b = within % 32

        # SA-mark test + rank from the same row
        mwords = rows[..., K.CP_MARK_OFF + 1:]
        mbit = (_pick(mwords, w) >> b) & 1
        mrank = rows[..., K.CP_MARK_OFF] + _popcount_sum(
            mwords & _lower_mask(within))
        rank = torch.where((mbit == 1) & ~done, mrank, rank)
        done = done | (mbit == 1)

        # BWT symbol + occ rank from the same row -> LF step
        p0 = rows[..., _A:_A + _W]
        p1 = rows[..., _A + _W:_A + 2 * _W]
        c0 = (_pick(p0, w) >> b) & 1
        c1 = (_pick(p1, w) >> b) & 1
        c = c0 | (c1 << 1)
        base = _pick(rows[..., :_A], c)
        ind = bnot(p0 ^ ((0 - c0) & MASK)[..., None]) \
            & bnot(p1 ^ ((0 - c1) & MASK)[..., None])
        occ_c = base + _popcount_sum(ind & _lower_mask(within))
        nxt = torch.minimum(_cbase(dix, blk, c) + occ_c, nmax - 1)
        cur = torch.where(done, cur, nxt)
        steps = torch.where(done, steps, steps + 1)

    sample = fetch_sa_samples(dix, blk * dix.samples_max + rank)
    return (sample + steps) & MASK


def extend_seeds(dix: DeviceIndex, block, patterns, starts, sp, ep,
                 ext_max: int, ext_occ: int):
    """Adaptive seed extension: a lane whose interval holds more than
    ext_occ rows prepends the read character left of its start, up to
    ext_max characters, stopping at the read start or when a step would
    empty the interval.  Returns (sp, ep, starts).  One kernel on the
    card."""
    return kernels.fm_extend(dix, block, patterns, starts, sp, ep, ext_max,
                             ext_occ)


def extend_lockstep(dix: DeviceIndex, block, patterns, starts, sp, ep,
                    ext_max: int, ext_occ: int):
    """`extend_seeds`, lockstep over lanes."""
    m = patterns.shape[-1]
    ts = torch.arange(ext_max, dtype=torch.int64, device=starts.device)
    j = (starts[..., None] - 1 - ts).clamp(0, m - 1)
    chars = torch.gather(patterns, -1, j).to(torch.int64)
    dead = torch.zeros(sp.shape, dtype=torch.bool, device=sp.device)
    for t in range(ext_max):
        active = ~dead & (wrap(ep - sp) > ext_occ) & (starts > 0)
        nsp, nep = extend_backward(dix, block, sp, ep, chars[..., t])
        empty = nep <= nsp
        take = active & ~empty
        sp = torch.where(take, nsp, sp)
        ep = torch.where(take, nep, ep)
        starts = torch.where(take, starts - 1, starts)
        dead = dead | (active & empty)
    return sp, ep, starts


def rolling_kmers(patterns, k: int):
    """Base-3 rolling k-mer codes over converted patterns (codes 1..3):
    out[..., j] = sum_{t<k} (patterns[..., j-t] - 1) * 3^t, the KLT index of
    the k-mer ending at j.  Positions j < k-1 mix in zeros."""
    d = patterns.to(torch.int64) - 1
    out = torch.zeros_like(d)
    p3 = 1
    for t in range(k):
        if t == 0:
            shifted = d
        else:
            shifted = torch.cat([torch.zeros_like(d[..., :t]), d[..., :-t]],
                                dim=-1)
        out = out + shifted * p3
        p3 *= 3
    return out


def klt_lookup(dix: DeviceIndex, block, kmer_idx):
    """(sp, ep) after klt_k backward steps: one row gather per lane."""
    row = block.to(torch.int64) * (3 ** dix.klt_k) + kmer_idx
    rows = widen(kernels.gather_rows(dix.klt, row.contiguous()))
    return rows[..., 0], rows[..., 1]


def search_patterns(dix: DeviceIndex, block, patterns, starts, ends,
                    max_len: int | None = None, end_kmers=None,
                    min_len: int = 0):
    """Batched backward search of seed slices [start, end).  end_kmers
    (rolling_kmers at end-1 per lane), when given and the index has a KLT,
    replaces the first klt_k steps of every slice at least klt_k long with
    one table lookup (bit-identical).  Returns (sp, ep).  One gather (the
    table lookup) and one kernel on the card.

    min_len is a lower bound on every slice length that the caller knows
    without a device sync (the host holds the read lengths); the lockstep
    version skips its short-slice phase when it is at least klt_k.  The
    default 0 (unknown) always runs that phase.
    """
    if max_len is None:
        max_len = patterns.shape[-1]
    k = dix.klt_k if end_kmers is not None else 0
    if k >= max_len:   # table deeper than any slice: plain path
        k = 0
    sp0 = ep0 = None
    if k:
        sp0, ep0 = klt_lookup(dix, block, end_kmers)
    return kernels.fm_search(dix, block, patterns, starts, ends, sp0, ep0, k,
                             max_len, min_len)


def search_lockstep(dix: DeviceIndex, block, patterns, starts, ends, sp0,
                    ep0, k: int, max_len: int, min_len: int = 0):
    """`search_patterns` after the table lookup, lockstep over lanes: lanes
    at least k long start from (sp0, ep0) at step k; lanes shorter than k
    walk their characters from (0, n) in a masked phase A, which is skipped
    when min_len >= k says that no lane is short (as the reference's
    lax.cond skips it)."""
    m = patterns.shape[-1]
    lens = ends - starts
    sp = torch.zeros(starts.shape, dtype=torch.int64, device=starts.device)
    ep = torch.broadcast_to(block_n(dix, block), starts.shape).clone()

    def chars_for(t0, t1):
        ts = torch.arange(t0, t1, dtype=torch.int64, device=ends.device)
        j = (ends[..., None] - 1 - ts).clamp(0, m - 1)
        return torch.gather(patterns, -1, j).to(torch.int64)

    def run(sp, ep, t0, t1, phase_mask=None):
        chars = chars_for(t0, t1)
        for t in range(t0, t1):
            active = (t < lens) & (ep > sp)    # freeze empties
            if phase_mask is not None:
                active = active & phase_mask
            nsp, nep = extend_backward(dix, block, sp, ep, chars[..., t - t0])
            sp = torch.where(active, nsp, sp)
            ep = torch.where(active, nep, ep)
        return sp, ep

    if k == 0:
        return run(sp, ep, 0, max_len)

    if min_len >= k:
        sp, ep = sp0, ep0
    else:
        short = lens < k
        sp_a, ep_a = run(sp, ep, 0, k, short)   # phase A: short lanes only
        sp = torch.where(short, sp_a, sp0)
        ep = torch.where(short, ep_a, ep0)
    return run(sp, ep, k, max_len)               # phase B
