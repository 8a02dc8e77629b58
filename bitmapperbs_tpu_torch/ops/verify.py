"""Verification ops (counterpart of bitmapperbs_tpu/ops/verify.py): bit-packed
window extraction, asymmetric bisulfite Hamming, multi-word bit-parallel Myers.

Plane words are u32 lanes carried as int64 (ops/u32.py).  Reads and
reference windows are 3 planes (bit0, bit1 of the 2-bit base code, N mask);
LSB = lowest position.  Everything is elementwise over an arbitrary lane
shape.  These are the plain versions; ops/kernels.py runs the hot Myers
loops as CUDA kernels on the card, and the genome-plane row gather of
window_planes goes through its gather_table (one gather_rows, or on a
sharded index one gather_rows_shard per shard and the partials summed).
"""
from __future__ import annotations

import torch

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.ops import kernels   # mutual import: used in calls
from bitmapperbs_tpu_torch.ops.u32 import (MASK, bnot, mask_lt, popcount,
                                           shl, wrap)

# u32 values >= this are wrapped-around negatives (window starts like
# anchor - e near position 0).  Real positions are < 2^32 - 4096.
_NEG_T = 0xFFFFF000


def pack_codes(codes: torch.Tensor):
    """uint8[..., m] base codes (0..3, 4=N) -> (b0, b1, nmask) u32[..., m/32].

    m must be a multiple of 32.  LSB = lowest position.
    """
    m = codes.shape[-1]
    assert m % 32 == 0
    shaped = codes.reshape(*codes.shape[:-1], m // 32, 32).to(torch.int64)
    w = torch.ones(32, dtype=torch.int64, device=codes.device) << torch.arange(
        32, device=codes.device)
    isn = shaped == K.N_CODE
    c = torch.where(isn, 0, shaped)
    b0 = ((c & 1) * w).sum(dim=-1)
    b1 = (((c >> 1) & 1) * w).sum(dim=-1)
    nm = (isn.to(torch.int64) * w).sum(dim=-1)
    return b0, b1, nm


def length_mask(lengths: torch.Tensor, m: int) -> torch.Tensor:
    """int lanes -> u32[..., m/32] mask of bits < length."""
    nw = m // 32
    ar = torch.arange(nw, dtype=torch.int64, device=lengths.device) * 32
    return mask_lt(lengths[..., None].to(torch.int64) - ar)


def window_planes(g_planes, orient, start, nwords: int, genome_len: int,
                  g_words: int | None = None):
    """`nwords` position-aligned u32 words per lane from the packed genome
    planes, starting at (possibly wrapped-negative) u32 `start`.

    g_planes: int32 bits [2 * W, 3] flat rows (block-0 words then block-1
    words; word 0 of each block is a zero pad so wrapped starts down to -32
    resolve through the +32 bias), or their index/device.Shards (then
    g_words, the per-block row count, is required).  orient: int lanes (0
    fwd / 1 rc).  Positions below 0 or at/after genome_len are N-filled,
    matching the oracle's frame_slice.  Returns (b0, b1, nmask), each
    u32[..., nwords].
    """
    W = g_words if g_words is not None else g_planes.shape[0] // 2
    dev = start.device
    sh = (start & 31)[..., None]
    wi = wrap(start + 32) >> 5                  # u32 add: wraps below 0
    offs = torch.arange(nwords + 1, dtype=torch.int64, device=dev)
    rows = (wi[..., None] + offs).clamp(0, W - 1)
    raw3 = kernels.gather_table(
        g_planes, (orient.to(torch.int64)[..., None] * W + rows).contiguous())
    raw3 = raw3.to(torch.int64) & MASK           # ..., nwords+1, 3

    def funnel(raw):
        lo, hi = raw[..., :-1], raw[..., 1:]
        return torch.where(sh == 0, lo, (lo >> sh) | shl(hi, 32 - sh))

    b0, b1, nm = (funnel(raw3[..., p]) for p in range(3))

    # out-of-range -> N: per word, positions [ws, ws + 32)
    ws = wrap(start[..., None]
              + torch.arange(nwords, dtype=torch.int64, device=dev) * 32)
    wrapped = ws >= _NEG_T
    neg_amt = wrap(-ws)
    low_invalid = torch.where(wrapped, mask_lt(neg_amt.clamp(max=32)), 0)
    valid_bits = torch.where(ws >= genome_len, 0,
                             (genome_len - ws).clamp(max=32))
    valid_bits = torch.where(wrapped, 32, valid_bits)
    oob = bnot(mask_lt(valid_bits)) | low_invalid
    return b0 & bnot(oob), b1 & bnot(oob), nm | oob


def frame_anchor(fwd, block, m, L):
    """fwd-genome anchor <-> frame anchor of a read of length m on a genome
    of length L (the map is its own inverse; block: int or int lanes)."""
    rc = wrap(L - fwd - m)
    if isinstance(block, int):
        return fwd if block == K.BLOCK_FWD else rc
    return torch.where(block == K.BLOCK_FWD, fwd, rc)


def hamming(ref_planes, read_planes, lenmask):
    """Asymmetric bisulfite mismatch count per lane (popcount over XOR).

    Rule (in-frame): match iff ref == read or (ref == C and read == T); N
    never matches.  Returns int32 lanes.
    """
    r0, r1, rn = ref_planes
    d0, d1, dn = read_planes
    eq = bnot(r0 ^ d0) & bnot(r1 ^ d1)
    ref_c = r0 & bnot(r1)          # C = 01 (bit0=1, bit1=0)
    read_t = d0 & d1               # T = 11
    match = (eq | (ref_c & read_t)) & bnot(rn) & bnot(dn)
    mism = bnot(match) & lenmask
    return popcount(mism).sum(dim=-1).to(torch.int32)


def shift_planes(planes, e: int, Wd: int):
    """(..., Ww >= Wd+1) plane words starting at anchor - e -> the (..., Wd)
    words starting at anchor, by an e-bit (< 32) right funnel shift; equals
    window_planes(anchor, Wd) since oob/N marking is per position.  (In the
    reference this is models/aligner._shift_planes.)"""
    if e == 0:
        return tuple(p[..., :Wd] for p in planes)
    return tuple((p[..., :Wd] >> e) | shl(p[..., 1:Wd + 1], 32 - e)
                 for p in planes)


def build_peq(frame_reads, lengths, m: int):
    """PEQ planes for Myers: u32[..., 4, m/32], plus the pad mask.

    PEQ[c] bit j == asym_match(ref_char=c, read[j]); rows >= length are
    always-match padding, so the padded pattern's distance equals the real
    read's.
    """
    d0, d1, dn = pack_codes(frame_reads)
    return peq_from_planes(d0, d1, dn, bnot(length_mask(lengths, m)))


def peq_from_planes(d0, d1, dn, pad):
    """PEQ (as build_peq) from already-packed read planes and the pad mask."""
    nd0, nd1, ndn = bnot(d0), bnot(d1), bnot(dn)
    is_a = nd0 & nd1 & ndn
    is_c = d0 & nd1 & ndn
    is_g = nd0 & d1 & ndn
    is_t = d0 & d1 & ndn
    peq = torch.stack([is_a | pad, is_c | is_t | pad, is_g | pad, is_t | pad],
                      dim=-2)
    return peq, pad


def _myers_scores(window_planes_, peq, pad, m: int, ncols: int):
    """The multi-word bit-parallel semi-global Myers recurrence, one window
    column at a time: yields the int64 score lanes D[m_pad][j] after each of
    the ncols columns.  Search variant: D[0][j] = 0, so the horizontal
    carry into row 0 is 0; N columns take the pad row."""
    wb0, wb1, wn = window_planes_
    Wd = m // 32
    lanes = torch.broadcast_shapes(wb0.shape[:-1], peq.shape[:-2],
                                   pad.shape[:-1])
    dev = pad.device
    peq = peq.expand(*lanes, 4, Wd)
    pad = pad.expand(*lanes, Wd)

    vp = torch.full((*lanes, Wd), MASK, dtype=torch.int64, device=dev)
    vn = torch.zeros((*lanes, Wd), dtype=torch.int64, device=dev)
    score = torch.full(lanes, m, dtype=torch.int64, device=dev)
    zero_col = torch.zeros((*lanes, 1), dtype=torch.int64, device=dev)

    def shl1(x):
        return shl(x, 1) | torch.cat([zero_col, x[..., :-1] >> 31], dim=-1)

    for j in range(ncols):
        w, b = j >> 5, j & 31
        c0 = (wb0[..., w] >> b) & 1
        c1 = (wb1[..., w] >> b) & 1
        cn = (wn[..., w] >> b) & 1
        code = (c0 | (c1 << 1))[..., None, None].expand(*lanes, 1, Wd)
        eq_sym = torch.gather(peq, -2, code)[..., 0, :]
        eq = torch.where((cn == 1)[..., None], pad, eq_sym)

        # D0 = (((eq & vp) + vp) ^ vp) | eq | vn, carry across words LSW first
        s1 = (eq & vp) + vp
        words, carry = [], None
        for wi in range(Wd):
            s = s1[..., wi] if carry is None else s1[..., wi] + carry
            carry = s >> 32
            words.append(s & MASK)
        ssum = torch.stack(words, dim=-1)
        d0 = (ssum ^ vp) | eq | vn
        hp = vn | bnot(d0 | vp)
        hn = vp & d0

        score = score + ((hp[..., Wd - 1] >> 31) & 1) \
            - ((hn[..., Wd - 1] >> 31) & 1)
        yield score

        x = shl1(hp)             # shift-in 0: free start
        vp = shl1(hn) | bnot(d0 | x)
        vn = d0 & x


def myers(window_planes_, peq, pad, m: int, ncols: int):
    """Multi-word bit-parallel semi-global edit distance per lane.

    window_planes_: (b0, b1, nmask) u32[..., Ww] covering ncols columns.
    peq: u32[..., 4, Wd]; pad: u32[..., Wd] (always-match rows).
    Returns int32 lanes: min over end columns (and the start score m) of
    D[m_pad][j], the real read's semi-global distance (pad rows are free
    diagonals).
    """
    best = None
    for score in _myers_scores(window_planes_, peq, pad, m, ncols):
        best = score if best is None else torch.minimum(best, score)
    return best.clamp(max=m).to(torch.int32)


def myers_scan(window_planes_, peq, pad, m: int, ncols: int):
    """Per-end-column semi-global scores: int32[..., ncols].

    The recurrence of `myers`, with every column's running score kept:
    out[..., j] = min edit distance of the (padded) read against any window
    infix ending at column j.  The pad rows are always-match diagonals, so
    out[..., j] is the REAL read's score for the alignment ending at column
    j - (m - length); mate rescue (models/paired.py) accounts for the shift.
    """
    return torch.stack(list(_myers_scores(window_planes_, peq, pad, m,
                                          ncols)), dim=-1).to(torch.int32)
