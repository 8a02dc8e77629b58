"""The reference's paired-end mapping with mate rescue: the configurations'
stated PE selection spec below (the port's numpy oracle, `oracle/paired.py`,
states the same rules); the records, mate fields and TLEN follow from the
chosen hits by SAM v1's definitions in `finalize.py`.

Frozen PE spec (device pipeline must reproduce):
- Mate frames: R1 searches PAT_CT frames, R2 searches PAT_GA frames
  (opposite conversion); non-directional adds the flipped pair for both.
- Proper pair: same block, different pattern (this implies FR orientation),
  forward-orientation mate's fwd_anchor <= reverse mate's, and
  insert = rev.fwd_anchor + len(rev read) - fwd.fwd_anchor in
  [min_insert, max_insert].
- Pair key = (score1+score2, fwd1, fwd2, bp1, bp2), lexicographic min.
- Second-best pair: any pair where EITHER mate is at a distinct locus from
  the best pair's corresponding mate (SE distinct rule).  Ambiguous pairs
  (equal sum) -> both mates MAPQ 0; else MAPQ gap table on the sums.
- No proper pair: mate rescue (below); if that fails, each mapped mate is
  emitted with its independent SE selection (no 0x2 flag).
- Mate rescue: anchor = the mate whose SE-selected best key is smaller
  (or the only mapped one).  One semi-global edit scan over the whole
  insert-compatible window of the missing mate in frame (block =
  anchored.block, pattern = opposite) -- see rescue() below for the frozen
  per-column rule; best (score, fwd_pos) wins if score <= e.  Rescued pair
  is proper; its MAPQ = min(anchored mate's own SE MAPQ, gap MAPQ over
  rescue scores at loci > e apart).
- Records (finalize.py): a chosen pair whose mate leaves its contig falls
  to the next stage; FLAG, RNEXT, PNEXT and TLEN by SAM v1.
"""
from __future__ import annotations

import numpy as np

from wgbs_bench.reference import align
from wgbs_bench.reference import constants as K
from wgbs_bench.reference import dna
from wgbs_bench.reference.config import Spec
from wgbs_bench.reference.index import Index
from wgbs_bench.reference.finalize import hit_record, mapq, mate_fields
from wgbs_bench.reference.pipeline import (Hit, frame_slice, locate_seeds,
                                           score_candidate, se_frames,
                                           se_hits, select_best)
from wgbs_bench.reference.sam import SamRecord, unmapped_record


def _is_rev(h: Hit) -> bool:
    return K.IS_REVERSE[(h.block, h.pat)]


def proper_pair(cfg: Spec, h1: Hit, h2: Hit, m1: int, m2: int):
    """Returns insert size if (h1, h2) is a proper FR pair else None."""
    if h1.block != h2.block or h1.pat == h2.pat:
        return None
    hf, mf = (h1, m1) if not _is_rev(h1) else (h2, m2)
    hr, mr = (h2, m2) if hf is h1 else (h1, m1)
    if hf.fwd_anchor > hr.fwd_anchor:
        return None
    insert = hr.fwd_anchor + mr - hf.fwd_anchor
    if cfg.min_insert <= insert <= cfg.max_insert:
        return insert
    return None


def pair_key(h1: Hit, h2: Hit):
    return (h1.score + h2.score, h1.fwd_anchor, h2.fwd_anchor,
            h1.block * 2 + h1.pat, h2.block * 2 + h2.pat)


def _distinct(a: Hit, b: Hit, e: int) -> bool:
    return (a.block, a.pat) != (b.block, b.pat) or abs(a.anchor - b.anchor) > e


def rescue_window(cfg: Spec, anchored: Hit, m_anch: int,
                  m_miss: int):
    """Frozen fwd-coordinate anchor range [lo, hi] for the missing mate."""
    A = anchored.fwd_anchor
    if not _is_rev(anchored):
        return A + cfg.min_insert - m_miss, A + cfg.max_insert - m_miss
    return A + m_anch - cfg.max_insert, A + m_anch - cfg.min_insert


def rescue(idx: Index, rc_ref, cfg: Spec, anchored: Hit,
           m_anch: int, miss_read: np.ndarray):
    """Windowed re-verification for the missing mate (SURVEY.md 3.3).

    Returns (best Hit | None, second_score | None) in the missing mate's
    frame (block = anchored.block, pattern = opposite of anchored's).

    Frozen spec, indel mode: ONE semi-global edit-distance scan over the
    whole insert window.  Per end column j (window coord a_lo - e + j),
    S[j] = min edit of the read vs any infix ending there; the candidate's
    frame anchor is A = end - m + 1, kept iff A lies in the offset range
    [a_lo, a_hi] and S <= e.  Best = lexicographic min of (S, fwd(A));
    second = min over candidates with |A - A_best| > e.  (One scan covers
    every offset's banded DP: the union of infixes is the same alignment
    set -- this is also exactly what the device computes with myers_scan,
    with a column shift of (bucket - length) from the pad rows.)
    Mismatch-only mode keeps the per-offset Hamming scan.
    """
    e = cfg.max_errors
    L = idx.genome.length
    m = len(miss_read)
    b = anchored.block
    p = K.PAT_GA if anchored.pat == K.PAT_CT else K.PAT_CT
    frame_ref = idx.genome.codes if b == K.BLOCK_FWD else rc_ref
    frame_read = miss_read if p == K.PAT_CT else dna.revcomp(miss_read)
    lo, hi = rescue_window(cfg, anchored, m_anch, m)
    lo = max(lo, 0)
    hi = min(hi, L - m)
    if lo > hi:
        return None, None

    if not cfg.indels or e == 0:
        cands = []
        for fwd in range(lo, hi + 1):
            a = fwd if b == K.BLOCK_FWD else L - fwd - m
            score = score_candidate(frame_ref, frame_read, a, cfg)
            if score <= e:
                cands.append(Hit(score, fwd, b, p, a))
        if not cands:
            return None, None
        best = min(cands, key=lambda h: h.key)
        distinct = [h for h in cands if abs(h.anchor - best.anchor) > e]
        second = min(distinct, key=lambda h: h.key) if distinct else None
        return best, (second.score if second else None)

    # frame-coordinate anchor range (contiguous either orientation)
    a_lo = lo if b == K.BLOCK_FWD else L - hi - m
    a_hi = hi if b == K.BLOCK_FWD else L - lo - m
    window = frame_slice(frame_ref, a_lo - e, (a_hi - a_lo) + m + 2 * e)
    S = align.edit_matrix(window, frame_read)[m, 1:]   # S[j], end col j
    cands = []
    for j in range(len(window)):
        A = a_lo - e + j - m + 1
        if S[j] > e or A < a_lo or A > a_hi:
            continue
        fwd = A if b == K.BLOCK_FWD else L - A - m
        cands.append(Hit(int(S[j]), fwd, b, p, A))
    if not cands:
        return None, None
    best = min(cands, key=lambda h: (h.score, h.fwd_anchor))
    distinct = [h for h in cands if abs(h.anchor - best.anchor) > e]
    second = min(distinct, key=lambda h: (h.score, h.fwd_anchor)) \
        if distinct else None
    return best, (second.score if second else None)


def _paired_flags(recs, proper: bool) -> None:
    """FLAG bits of two mates by their definitions, in place: 0x1, 0x2 when
    proper, 0x40 / 0x80, 0x8 and 0x20 from the mate's own record."""
    for k, (r, mate) in enumerate(((recs[0], recs[1]), (recs[1], recs[0]))):
        r.flag |= K.FLAG_PAIRED | (K.FLAG_READ1 if k == 0 else K.FLAG_READ2)
        if proper:
            r.flag |= K.FLAG_PROPER
        if mate.flag & K.FLAG_UNMAPPED:
            r.flag |= K.FLAG_MATE_UNMAPPED
        elif mate.flag & K.FLAG_REVERSE:
            r.flag |= K.FLAG_MATE_REVERSE
    r1, r2 = recs
    unmapped = [bool(r.flag & K.FLAG_UNMAPPED) for r in recs]
    if not any(unmapped):
        mate_fields(r1, r2)
    elif not all(unmapped):     # the unmapped mate points at the mapped one
        r, mate = (r1, r2) if unmapped[0] else (r2, r1)
        r.rnext, r.pnext = mate.rname, mate.pos


def _proper(idx, cfg, reads, quals, qname, h1, h2, mq):
    """Both mates' records at a chosen pair; None where either leaves its
    contig."""
    recs = [hit_record(idx.genome, cfg, np.asarray(reads[i]), quals[i],
                       qname, h, mq) for i, h in ((0, h1), (1, h2))]
    if None in recs:
        return None
    _paired_flags(recs, True)
    return recs


def map_pair(idx: Index, rc_ref, cfg: Spec, r1, r2,
             quals=("", ""), qname="p"):
    """One read pair -> two SamRecords (frozen spec above)."""
    e = cfg.max_errors
    reads = (np.asarray(r1, np.uint8), np.asarray(r2, np.uint8))
    hits1, _ = se_hits(idx, rc_ref, cfg, reads[0], se_frames(cfg, mate=0))
    hits2, _ = se_hits(idx, rc_ref, cfg, reads[1], se_frames(cfg, mate=1))

    pairs = [(h1, h2) for h1 in hits1 for h2 in hits2
             if proper_pair(cfg, h1, h2, len(reads[0]), len(reads[1]))]
    if pairs:
        best = min(pairs, key=lambda p: pair_key(*p))
        distinct = [p for p in pairs
                    if _distinct(p[0], best[0], e) or _distinct(p[1], best[1], e)]
        second = min(distinct, key=lambda p: pair_key(*p)) if distinct else None
        ssum = best[0].score + best[1].score
        mq = mapq(cfg, ssum, pair_key(*second)[0] if second else None)
        recs = _proper(idx, cfg, reads, quals, qname, best[0], best[1], mq)
        if recs:
            return recs

    # --- mate rescue -------------------------------------------------------
    b1, s1 = select_best(hits1, e)
    b2, s2 = select_best(hits2, e)
    if b1 is not None or b2 is not None:
        if b2 is None or (b1 is not None and b1.key <= b2.key):
            anch_i = 0
            anchored, anch_second = b1, s1
        else:
            anch_i = 1
            anchored, anch_second = b2, s2
        miss_i = 1 - anch_i
        rb, rsecond = rescue(idx, rc_ref, cfg, anchored,
                             len(reads[anch_i]), reads[miss_i])
        if rb is not None:
            mq = min(mapq(cfg, anchored.score,
                          anch_second.score if anch_second else None),
                     mapq(cfg, rb.score, rsecond))
            ordered = (anchored, rb) if anch_i == 0 else (rb, anchored)
            recs = _proper(idx, cfg, reads, quals, qname, ordered[0],
                           ordered[1], mq)
            if recs:
                return recs

    # --- discordant / singleton fallback -----------------------------------
    recs = []
    for i, hits in ((0, hits1), (1, hits2)):
        best, second = select_best(hits, e)
        rec = None
        if best is not None and (cfg.report_ambiguous
                                 or second is None
                                 or second.score != best.score):
            rec = hit_record(idx.genome, cfg, reads[i], quals[i], qname,
                             best, mapq(cfg, best.score,
                                        second.score if second else None))
        recs.append(rec or unmapped_record(qname, reads[i], quals[i]))
    _paired_flags(recs, False)
    return recs


def map_batch_pe(idx: Index, cfg: Spec, pairs, quals=None,
                 qnames=None) -> list[SamRecord]:
    rc_ref = idx.genome.rc_codes()
    locate_seeds(idx, cfg, [np.asarray(r) for p in pairs for r in p])
    out = []
    for i, (r1, r2) in enumerate(pairs):
        q = quals[i] if quals else ("", "")
        qn = qnames[i] if qnames else f"p{i}"
        out.extend(map_pair(idx, rc_ref, cfg, r1, r2, q, qn))
    return out
