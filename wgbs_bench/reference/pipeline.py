"""The reference's single-end mapping: convert -> seed -> locate -> filter ->
verify -> select, one read at a time on the host; the record then follows
from the hit by `finalize.py`, which shares no code with any aligner.

Seeding, verification and selection are the configurations' stated spec
(the port's numpy oracle, `oracle/pipeline.py`, states the same rules),
with two changes of means and none of result: the seeds are found by a scan
of the converted genome (`reference/index.py`) instead of an FM-index, and
a frame's candidates are scored together (`align.edit_distances`).

Selection spec:
- candidate key = (score, fwd_anchor, block, pattern); best = lexicographic
  min, an order-free reduction.
- second-best = min over candidates at a distinct locus: different
  (block, pattern) or |anchor - best_anchor| > max_errors.
- ambiguous iff second exists with second.score == best.score.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from wgbs_bench.reference import align
from wgbs_bench.reference import constants as K
from wgbs_bench.reference import dna
from wgbs_bench.reference.config import Spec
from wgbs_bench.reference.finalize import hit_record, mapq
from wgbs_bench.reference.index import Index
from wgbs_bench.reference.sam import SamRecord, unmapped_record


@dataclasses.dataclass(frozen=True)
class Hit:
    score: int
    fwd_anchor: int   # anchor mapped to forward-genome coordinates
    block: int
    pat: int
    anchor: int       # frame-local anchor (block-0: == fwd_anchor)

    @property
    def key(self):
        return (self.score, self.fwd_anchor, self.block, self.pat)


def frame_slice(frame_ref: np.ndarray, start: int, length: int) -> np.ndarray:
    """frame_ref[start:start+length] with out-of-range filled by N."""
    out = np.full(length, K.N_CODE, dtype=np.uint8)
    s, t = max(start, 0), min(start + length, len(frame_ref))
    if t > s:
        out[s - start:t - start] = frame_ref[s:t]
    return out


def seed_slices(m: int, num_seeds: int) -> list[tuple[int, int]]:
    """Pigeonhole seeds: e+1 equal slices (frozen seeding policy, C9)."""
    return [(s * m // num_seeds, (s + 1) * m // num_seeds)
            for s in range(num_seeds)]


def collect_candidates(idx: Index, cfg: Spec, pat: np.ndarray,
                       block_id: int, m: int) -> tuple[list[int], bool]:
    """Seed + locate -> sorted, deduped, capped frame anchors.

    Returns (anchors, overflowed).  A seed that occurs more than
    max_seed_occ times contributes nothing; a heavy seed first grows left,
    one read character at a time, while it occurs more than seed_ext_occ
    times, up to seed_ext_max characters and the read start, keeping its
    last nonempty set of occurrences.  The kept seeds' occurrences go in
    ascending count order (ties by seed index), each seed's in the order of
    the suffixes that start there, and past locate_budget of them the rest
    are dropped; anchors beyond max_candidates are dropped after sorting.
    """
    block = idx.blocks[block_id]
    overflow = False
    seeds = []
    for si, (start, end) in enumerate(seed_slices(m, cfg.num_seeds)):
        cnt = block.count(pat[start:end])
        if cfg.seed_ext_max:
            k = 0
            while (cnt > cfg.seed_ext_occ and start > 0
                   and k < cfg.seed_ext_max):
                grown = block.count(pat[start - 1:end])
                if not grown:
                    break
                cnt = grown
                start -= 1
                k += 1
        if cnt == 0:
            continue
        if cnt > cfg.max_seed_occ:
            overflow = True
            continue
        seeds.append((cnt, si, block.find(pat[start:end]), start))
    budget = cfg.locate_budget
    anchors: set[int] = set()
    for cnt, _, occ, start in sorted(seeds, key=lambda s: s[:2]):
        if cnt > budget:
            occ = block.suffix_sorted(occ)[:budget]
            overflow = True
        budget -= len(occ)
        a = occ.astype(np.int64) - start
        anchors.update(int(x) for x in a[(a >= 0) & (a <= block.n - 1 - m)])
    out = sorted(anchors)
    if len(out) > cfg.max_candidates:
        out = out[:cfg.max_candidates]
        overflow = True
    return out, overflow


def locate_seeds(idx: Index, cfg: Spec, reads) -> None:
    """Counts the seeds of every read, in either orientation, in one pass
    over each block; then, in one more pass, every way the spec may grow a
    seed to the left whose positions were too many to keep (a grown seed
    whose shorter form has its positions kept is counted from them)."""
    seeds = []
    for read in reads:
        for r in (read, dna.revcomp(read)):
            pat = dna.ct_convert(r)
            seeds += [(pat, a, b) for a, b in seed_slices(len(r),
                                                           cfg.num_seeds)]
    for block in idx.blocks:
        block.locate([pat[a:b] for pat, a, b in seeds])
        block.locate([pat[a - k:b] for pat, a, b in seeds
                      if block.count(pat[a:b]) > cfg.seed_ext_occ
                      and pat[a:b].tobytes() not in block.where
                      for k in range(1, min(cfg.seed_ext_max, a) + 1)])


def score_candidate(frame_ref: np.ndarray, frame_read: np.ndarray,
                    anchor: int, cfg: Spec) -> int:
    """Frozen scoring: d_ham fast path, else banded edit (call stack 3.4)."""
    m = len(frame_read)
    e = cfg.max_errors
    ham = align.hamming(frame_slice(frame_ref, anchor, m), frame_read)
    if ham <= e or not cfg.indels:
        return ham
    window = frame_slice(frame_ref, anchor - e, m + 2 * e)
    return align.edit_distance(window, frame_read)


def se_frames(cfg: Spec, mate: int = 0) -> list[tuple[int, int]]:
    """(pattern, block) frames for a read.  Mate 2 of a pair uses the
    opposite conversion (SURVEY.md call stack 3.3: "mate2 uses opposite
    conversion/orientation"); non-directional mode adds the other pair."""
    first = K.PAT_CT if mate == 0 else K.PAT_GA
    out = [(first, K.BLOCK_FWD), (first, K.BLOCK_RC)]
    if cfg.non_directional:
        other = K.PAT_GA if mate == 0 else K.PAT_CT
        out += [(other, K.BLOCK_FWD), (other, K.BLOCK_RC)]
    return out


def frame_windows(frame_ref: np.ndarray, starts: np.ndarray,
                  length: int) -> np.ndarray:
    """frame_slice of each start, as rows."""
    pos = starts[:, None] + np.arange(length)
    ok = (pos >= 0) & (pos < len(frame_ref))
    return np.where(ok, frame_ref[np.clip(pos, 0, len(frame_ref) - 1)],
                    K.N_CODE).astype(np.uint8)


def score_candidates(frame_ref: np.ndarray, frame_read: np.ndarray,
                     anchors: np.ndarray, cfg: Spec) -> np.ndarray:
    """score_candidate of every anchor; a score over max_errors may read as
    any value over it."""
    m = len(frame_read)
    e = cfg.max_errors
    ham = (~align.asym_match(frame_windows(frame_ref, anchors, m),
                             frame_read[None, :])).sum(1)
    if not cfg.indels:
        return ham
    score = ham.copy()
    far = np.flatnonzero(ham > e)
    if len(far):
        score[far] = align.edit_distances(
            frame_windows(frame_ref, anchors[far] - e, m + 2 * e),
            frame_read, e)
    return score


def se_hits(idx: Index, rc_ref: np.ndarray, cfg: Spec,
            read: np.ndarray, frames: list[tuple[int, int]]):
    """All scoring candidates of one read over the given frames."""
    m = len(read)
    e = cfg.max_errors
    L = idx.genome.length
    hits: list[Hit] = []
    overflow = False
    frame_reads = {K.PAT_CT: read, K.PAT_GA: dna.revcomp(read)}
    for p, b in frames:
        frame_read = frame_reads[p]
        pat = dna.ct_convert(frame_read)
        frame_ref = idx.genome.codes if b == K.BLOCK_FWD else rc_ref
        anchors, ovf = collect_candidates(idx, cfg, pat, b, m)
        overflow |= ovf
        if not anchors:
            continue
        scores = score_candidates(frame_ref, frame_read,
                                  np.asarray(anchors, dtype=np.int64), cfg)
        for a, score in zip(anchors, scores):
            if score > e:
                continue
            fwd_anchor = a if b == K.BLOCK_FWD else L - a - m
            hits.append(Hit(int(score), fwd_anchor, b, p, a))
    return hits, overflow


def select_best(hits: list[Hit], e: int):
    """Frozen order-free (best, second) selection shared by SE and PE."""
    if not hits:
        return None, None
    best = min(hits, key=lambda h: h.key)
    distinct = [h for h in hits
                if (h.block, h.pat) != (best.block, best.pat)
                or abs(h.anchor - best.anchor) > e]
    second = min(distinct, key=lambda h: h.key) if distinct else None
    return best, second


def map_read_se(idx: Index, rc_ref: np.ndarray, cfg: Spec,
                read: np.ndarray):
    """One read -> (best Hit | None, second Hit | None, stats dict)."""
    hits, overflow = se_hits(idx, rc_ref, cfg, read, se_frames(cfg))
    best, second = select_best(hits, cfg.max_errors)
    return best, second, {"overflow": overflow}


def map_batch_se(idx: Index, cfg: Spec, reads, quals=None,
                 qnames=None) -> list[SamRecord]:
    """Single-end reads -> one SAM record each."""
    rc_ref = idx.genome.rc_codes()
    locate_seeds(idx, cfg, [np.asarray(r) for r in reads])
    quals = quals or [""] * len(reads)
    qnames = qnames or [f"r{i}" for i in range(len(reads))]
    out = []
    for read, qual, qname in zip(reads, quals, qnames):
        read = np.asarray(read)
        best, second, _ = map_read_se(idx, rc_ref, cfg, read)
        rec = None
        ambiguous = second is not None and best is not None \
            and second.score == best.score
        if best is not None and (cfg.report_ambiguous or not ambiguous):
            rec = hit_record(idx.genome, cfg, read, qual, qname, best,
                             mapq(cfg, best.score,
                                  second.score if second else None))
        if rec is None:
            rec = unmapped_record(qname, read, qual)
        out.append(rec)
    return out
