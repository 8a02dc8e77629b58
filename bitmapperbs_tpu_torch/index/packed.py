"""Host (numpy) readers over PackedBlock: occ/rank, backward search, locate.

This is the scalable CPU implementation of the FM-index runtime (SURVEY.md
C7/C8) over the *same physical layout* the device kernels read, so device
parity tests compare against it, and it in turn is tested against the naive
cumsum oracle (oracle/fm.py).  All APIs are vectorized over a batch axis.
"""
from __future__ import annotations

import numpy as np

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.index.build import PackedBlock

_A = K.CONV_ALPHA        # 4: checkpoint counts per row
_W = K.CP_WORDS          # 4: words per plane per row


def _lower_bits_mask(within: np.ndarray) -> np.ndarray:
    """Per-word masks selecting bit positions < `within` across _W u32 words."""
    wpos = np.arange(_W, dtype=np.int64) * 32
    nbits = np.clip(within[..., None].astype(np.int64) - wpos, 0, 32)
    return ((np.uint64(1) << nbits.astype(np.uint64)) - 1).astype(np.uint32)


def _indicator_words(row_words: np.ndarray, c) -> np.ndarray:
    """Rows' plane words -> per-word indicator bits for symbol code c.

    row_words: uint32[..., 2*_W] = plane0 words then plane1 words.
    c: scalar or broadcastable int array of symbol codes (0..3).
    """
    p0 = row_words[..., :_W]
    p1 = row_words[..., _W:]
    c = np.asarray(c, dtype=np.uint32)
    b0 = (c & 1)[..., None] * np.uint32(0xFFFFFFFF)
    b1 = ((c >> 1) & 1)[..., None] * np.uint32(0xFFFFFFFF)
    return ~(p0 ^ b0) & ~(p1 ^ b1)


def occ(block: PackedBlock, c, i) -> np.ndarray:
    """# of occurrences of symbol `c` in BWT[0:i). Vectorized over c, i."""
    c = np.asarray(c, dtype=np.uint32)
    i = np.asarray(i, dtype=np.uint64)
    row = (i // K.CP_BLOCK).astype(np.int64)
    within = (i % K.CP_BLOCK).astype(np.uint32)
    rows = block.cp_rows[row]                      # [..., CP_ROW_U32]
    base = np.take_along_axis(rows[..., :_A], c[..., None].astype(np.int64), -1)[..., 0]
    ind = _indicator_words(rows[..., _A:_A + 2 * _W], c)      # [..., _W]
    mask = _lower_bits_mask(within)
    cnt = np.bitwise_count(ind & mask).sum(axis=-1).astype(np.uint64)
    return (base.astype(np.uint64) + cnt).astype(np.uint64)


def bwt_symbol(block: PackedBlock, i) -> np.ndarray:
    """BWT[i] symbol codes, vectorized."""
    i = np.asarray(i, dtype=np.uint64)
    row = (i // K.CP_BLOCK).astype(np.int64)
    within = (i % K.CP_BLOCK).astype(np.uint32)
    w = (within // 32).astype(np.int64)
    b = within % 32
    rows = block.cp_rows[row]
    p0 = np.take_along_axis(rows[..., _A:_A + _W], w[..., None], -1)[..., 0]
    p1 = np.take_along_axis(rows[..., _A + _W:_A + 2 * _W], w[..., None], -1)[..., 0]
    return (((p0 >> b) & 1) | (((p1 >> b) & 1) << 1)).astype(np.uint8)


def extend_backward(block: PackedBlock, sp, ep, c):
    """One backward-search step: (sp, ep, symbol) -> (sp', ep')."""
    c = np.asarray(c)
    cb = block.cbase[c].astype(np.uint64)
    return cb + occ(block, c, sp), cb + occ(block, c, ep)


def count(block: PackedBlock, pattern: np.ndarray):
    """Full backward search of one converted pattern. Returns (sp, ep)."""
    sp = np.uint64(0)
    ep = np.uint64(block.n)
    for c in pattern[::-1]:
        sp, ep = extend_backward(block, sp, ep, int(c))
        if sp >= ep:
            break
    return int(sp), int(ep)


def lf(block: PackedBlock, i) -> np.ndarray:
    c = bwt_symbol(block, i)
    return block.cbase[c].astype(np.uint64) + occ(block, c, i)


def _mark_rank(block: PackedBlock, i):
    """(is_marked, rank-of-marked-rows-before-i) for SA-sample lookup."""
    i = np.asarray(i, dtype=np.uint64)
    row = (i // K.CP_BLOCK).astype(np.int64)
    within = (i % K.CP_BLOCK).astype(np.uint32)
    rows = block.cp_rows[row]
    base = rows[..., K.CP_MARK_OFF].astype(np.uint64)
    words = rows[..., K.CP_MARK_OFF + 1:]
    mask = _lower_bits_mask(within)
    rank = base + np.bitwise_count(words & mask).sum(axis=-1).astype(np.uint64)
    w = (within // 32).astype(np.int64)
    bit = np.take_along_axis(words, w[..., None], -1)[..., 0] >> (within % 32) & 1
    return bit.astype(bool), rank


def locate(block: PackedBlock, i) -> np.ndarray:
    """SA[i] via LF-walk to a marked row (< block.sa_rate steps), vectorized.

    Reference parity: C8.  The walk is a fixed unroll with done-masking --
    the same schedule the device kernel uses (SURVEY.md hard-part 1).
    """
    i = np.atleast_1d(np.asarray(i, dtype=np.uint64)).copy()
    steps = np.zeros_like(i)
    out = np.zeros_like(i)
    done = np.zeros(i.shape, dtype=bool)
    for _ in range(block.sa_rate):
        m, rank = _mark_rank(block, i)
        hit = m & ~done
        out[hit] = block.sa_samples[rank[hit].astype(np.int64)].astype(np.uint64) + steps[hit]
        done |= m
        if done.all():
            break
        nxt = lf(block, i)
        i = np.where(done, i, nxt)
        steps = np.where(done, steps, steps + 1)
    assert done.all(), "LF walk exceeded sa_rate steps"
    return out
