"""Paired-end oracle engine with mate rescue (SURVEY.md C15, call stack 3.3;
BASELINE config 3).

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
- Mate fields (SAM v1 1.4, `mate_fields`): two mapped mates give each
  other RNEXT (`=` on one contig) and PNEXT; on one contig TLEN runs from
  the leftmost to the rightmost mapped base of the two, plus on the
  leftmost mate (mate 1 at equal POS), minus on the other; 0 across
  contigs.  An unmapped mate (RNAME `*`, POS 0) takes its mapped mate's
  RNAME / POS as RNEXT / PNEXT.  (The JAX package writes RNEXT `*` / PNEXT
  0 on an unmapped mate, TLEN 0 for a pair that is not proper, and ends a
  proper pair's TLEN at the right-starting mate's end.)
"""
from __future__ import annotations

import numpy as np

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.config import AlignerConfig
from bitmapperbs_tpu_torch.index.build import BSIndex
from bitmapperbs_tpu_torch.io.sam import SamRecord, unmapped_record
from bitmapperbs_tpu_torch.oracle.pipeline import (Hit, finalize_hit, se_frames,
                                             se_hits, select_best,
                                             score_candidate)
from bitmapperbs_tpu_torch.utils import dna


def _is_rev(h: Hit) -> bool:
    return K.IS_REVERSE[(h.block, h.pat)]


def proper_pair(cfg: AlignerConfig, h1: Hit, h2: Hit, m1: int, m2: int):
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


def rescue_window(cfg: AlignerConfig, anchored: Hit, m_anch: int,
                  m_miss: int):
    """Frozen fwd-coordinate anchor range [lo, hi] for the missing mate."""
    A = anchored.fwd_anchor
    if not _is_rev(anchored):
        return A + cfg.min_insert - m_miss, A + cfg.max_insert - m_miss
    return A + m_anch - cfg.max_insert, A + m_anch - cfg.min_insert


def rescue(idx: BSIndex, rc_ref, cfg: AlignerConfig, anchored: Hit,
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
    from bitmapperbs_tpu_torch.oracle import align
    from bitmapperbs_tpu_torch.oracle.pipeline import frame_slice

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


def _emit_pair(idx, rc_ref, cfg, reads, quals, qname, h1, h2, mapq1, mapq2):
    """Finalize both mates, patch PE fields.  Returns records or None."""
    base = [K.FLAG_PAIRED | K.FLAG_PROPER | K.FLAG_READ1,
            K.FLAG_PAIRED | K.FLAG_PROPER | K.FLAG_READ2]
    hits = [h1, h2]
    recs = []
    for i in (0, 1):
        other = hits[1 - i]
        extra = base[i] | (K.FLAG_MATE_REVERSE if _is_rev(other) else 0)
        rec = finalize_hit(idx, rc_ref, cfg, np.asarray(reads[i]), quals[i],
                           qname, hits[i], None, flag_extra=extra,
                           mapq_override=[mapq1, mapq2][i])
        if rec is None:
            return None
        recs.append(rec)
    mate_fields(*recs)
    return recs


def cigar_ref_span(cig: str) -> int:
    """Reference bases a CIGAR consumes (M / D ops).  The ungapped "NNM"
    form, nearly every record, parses without a loop."""
    if cig[-1] == "M" and cig[:-1].isdigit():
        return int(cig[:-1])
    span = v = 0
    for ch in cig:
        if "0" <= ch <= "9":
            v = v * 10 + ord(ch) - 48
        else:
            if ch in "MD":
                span += v
            v = 0
    return span


def mate_fields(r1: SamRecord, r2: SamRecord) -> None:
    """RNEXT, PNEXT and TLEN of a pair's two records, in place (the module
    docstring's rule); FLAG and MAPQ are left as they are."""
    u1, u2 = r1.flag & K.FLAG_UNMAPPED, r2.flag & K.FLAG_UNMAPPED
    if u1 or u2:
        if not (u1 and u2):
            r, mate = (r1, r2) if u1 else (r2, r1)
            r.rnext, r.pnext = mate.rname, mate.pos
        return
    same = r1.rname == r2.rname
    r1.rnext, r2.rnext = ("=", "=") if same else (r2.rname, r1.rname)
    r1.pnext, r2.pnext = r2.pos, r1.pos
    if not same:
        return
    left, right = (r1, r2) if r1.pos <= r2.pos else (r2, r1)
    tlen = max(r1.pos + cigar_ref_span(r1.cigar),
               r2.pos + cigar_ref_span(r2.cigar)) - left.pos
    left.tlen, right.tlen = tlen, -tlen


def map_pair(idx: BSIndex, rc_ref, cfg: AlignerConfig, r1, r2,
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
        if second and pair_key(*second)[0] == ssum:
            mapq = 0
        else:
            mapq = K.mapq_from_gap(ssum,
                                   pair_key(*second)[0] if second else None)
        recs = _emit_pair(idx, rc_ref, cfg, reads, quals, qname,
                          best[0], best[1], mapq, mapq)
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
            anch_amb = anch_second is not None and \
                anch_second.score == anchored.score
            anch_mapq = 0 if anch_amb else K.mapq_from_gap(
                anchored.score, anch_second.score if anch_second else None)
            resc_mapq = 0 if (rsecond is not None and rsecond == rb.score) \
                else K.mapq_from_gap(rb.score, rsecond)
            mapq = min(anch_mapq, resc_mapq)
            ordered = (anchored, rb) if anch_i == 0 else (rb, anchored)
            recs = _emit_pair(idx, rc_ref, cfg, reads, quals, qname,
                              ordered[0], ordered[1], mapq, mapq)
            if recs:
                return recs

    # --- discordant / singleton fallback -----------------------------------
    sel = [select_best(hits1, e), select_best(hits2, e)]
    recs = []
    for i in (0, 1):
        best, second = sel[i]
        mate_best = sel[1 - i][0]
        extra = K.FLAG_PAIRED | (K.FLAG_READ1 if i == 0 else K.FLAG_READ2)
        if mate_best is None:
            extra |= K.FLAG_MATE_UNMAPPED
        elif _is_rev(mate_best):
            extra |= K.FLAG_MATE_REVERSE
        rec = None
        if best is not None:
            rec = finalize_hit(idx, rc_ref, cfg, reads[i], quals[i], qname,
                               best, second, flag_extra=extra)
        if rec is None:
            rec = unmapped_record(qname, reads[i], quals[i], flag_extra=extra)
        recs.append(rec)
    mate_fields(*recs)
    return recs


def map_batch_pe(idx: BSIndex, cfg: AlignerConfig, pairs, quals=None,
                 qnames=None) -> list[SamRecord]:
    rc_ref = idx.genome.rc_codes()
    out = []
    for i, (r1, r2) in enumerate(pairs):
        q = quals[i] if quals else ("", "")
        qn = qnames[i] if qnames else f"p{i}"
        out.extend(map_pair(idx, rc_ref, cfg, r1, r2, q, qn))
    return out
