"""Pure-CPU oracle mapping pipeline, single-end (SURVEY.md section 4 item 1,
call stack 3.2): convert -> seed -> locate -> filter -> verify -> select ->
traceback -> SAM.

This module *is* the frozen behavioral spec.  The device pipeline
(models/aligner.py) must produce identical (best, second) hit tuples per read;
`finalize_hit` here is shared by both paths, so SAM equality then holds by
construction.

Frozen selection spec (SURVEY.md section 7 hard-part 3):
- candidate key = (score, fwd_anchor, block, pattern); best = lexicographic min
  -- an order-free reduction, so device shardings cannot change the output.
- second-best = min over candidates at a distinct locus: different
  (block, pattern) or |anchor - best_anchor| > max_errors.
- ambiguous iff second exists with second.score == best.score.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.config import AlignerConfig
from bitmapperbs_tpu_torch.index import packed
from bitmapperbs_tpu_torch.index.build import BSIndex
from bitmapperbs_tpu_torch.io.sam import SamRecord, unmapped_record
from bitmapperbs_tpu_torch.oracle import align
from bitmapperbs_tpu_torch.utils import dna


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


def collect_candidates(idx: BSIndex, cfg: AlignerConfig, pat: np.ndarray,
                       block_id: int, m: int) -> tuple[list[int], bool]:
    """Seed + locate -> sorted, deduped, capped frame anchors (C9/C10).

    Returns (anchors, overflowed).  A seed whose interval exceeds
    max_seed_occ contributes nothing (frequency threshold, frozen);
    anchors beyond max_candidates are dropped after sorting (frozen).
    """
    block = idx.blocks[block_id]
    overflow = False
    seeds = []
    for si, (start, end) in enumerate(seed_slices(m, cfg.num_seeds)):
        sp, ep = packed.count(block, pat[start:end])
        # adaptive extension (C9 "extend until rare", frozen semantics
        # mirrored by ops/fm.extend_seeds): a heavy seed keeps prepending
        # the read character left of its start, stopping at the read start,
        # seed_ext_max characters, or when one more character would EMPTY
        # the interval (keep the last nonempty interval and stop -- the
        # characters must stay consecutive)
        if cfg.seed_ext_max:
            k = 0
            while (ep - sp > cfg.seed_ext_occ and start > 0
                   and k < cfg.seed_ext_max):
                nsp, nep = packed.extend_backward(
                    block, np.uint64(sp), np.uint64(ep),
                    int(pat[start - 1]))
                if nsp >= nep:
                    break
                sp, ep = int(nsp), int(nep)
                start -= 1
                k += 1
        cnt = ep - sp
        if cnt == 0:
            continue
        if cnt > cfg.max_seed_occ:
            overflow = True
            continue
        seeds.append((int(cnt), si, int(sp), start))
    # frozen: expand seeds in ASCENDING frequency (ties by seed index) so
    # locate-budget truncation drops the least-informative (junk) entries
    # first -- critical at large genomes where T-rich seeds are heavy-tailed
    entries: list[tuple[int, int]] = []   # (sa_row, seed_start)
    for cnt, _, sp, start in sorted(seeds):
        entries.extend((sp + k, start) for k in range(cnt))
    if len(entries) > cfg.locate_budget:
        entries = entries[:cfg.locate_budget]
        overflow = True
    anchors: set[int] = set()
    if entries:
        tps = packed.locate(block, np.array([r for r, _ in entries]))
        for tp, (_, start) in zip(tps.astype(np.int64), entries):
            a = int(tp) - start
            if 0 <= a <= block.n - 1 - m:
                anchors.add(a)
    out = sorted(anchors)
    if len(out) > cfg.max_candidates:
        out = out[:cfg.max_candidates]
        overflow = True
    return out, overflow


def score_candidate(frame_ref: np.ndarray, frame_read: np.ndarray,
                    anchor: int, cfg: AlignerConfig) -> int:
    """Frozen scoring: d_ham fast path, else banded edit (call stack 3.4)."""
    m = len(frame_read)
    e = cfg.max_errors
    ham = align.hamming(frame_slice(frame_ref, anchor, m), frame_read)
    if ham <= e or not cfg.indels:
        return ham
    window = frame_slice(frame_ref, anchor - e, m + 2 * e)
    return align.edit_distance(window, frame_read)


def se_frames(cfg: AlignerConfig, mate: int = 0) -> list[tuple[int, int]]:
    """(pattern, block) frames for a read.  Mate 2 of a pair uses the
    opposite conversion (SURVEY.md call stack 3.3: "mate2 uses opposite
    conversion/orientation"); non-directional mode adds the other pair."""
    first = K.PAT_CT if mate == 0 else K.PAT_GA
    out = [(first, K.BLOCK_FWD), (first, K.BLOCK_RC)]
    if cfg.non_directional:
        other = K.PAT_GA if mate == 0 else K.PAT_CT
        out += [(other, K.BLOCK_FWD), (other, K.BLOCK_RC)]
    return out


def se_hits(idx: BSIndex, rc_ref: np.ndarray, cfg: AlignerConfig,
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
        for a in anchors:
            score = score_candidate(frame_ref, frame_read, a, cfg)
            if score > e:
                continue
            fwd_anchor = a if b == K.BLOCK_FWD else L - a - m
            hits.append(Hit(score, fwd_anchor, b, p, a))
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


def map_read_se(idx: BSIndex, rc_ref: np.ndarray, cfg: AlignerConfig,
                read: np.ndarray):
    """One read -> (best Hit | None, second Hit | None, stats dict)."""
    hits, overflow = se_hits(idx, rc_ref, cfg, read, se_frames(cfg))
    best, second = select_best(hits, cfg.max_errors)
    return best, second, {"overflow": overflow}


def finalize_hit(idx: BSIndex, rc_ref: np.ndarray, cfg: AlignerConfig,
                 read: np.ndarray, qual: str, qname: str,
                 best: Hit, second: Hit | None,
                 flag_extra: int = 0,
                 mapq_override: int | None = None,
                 traceback_pre=None) -> SamRecord | None:
    """Traceback + SAM field construction (C13/C14/C18 host side).

    Shared verbatim by the oracle and the device pipeline's host stage.
    Returns None when the alignment is rejected (e.g. leaves its contig).
    traceback_pre: optional (ref_start, cigar_ops) already computed by the
    batched traceback (models/finalize.py) -- skips the per-read hamming
    recheck + DP walk.
    """
    m = len(read)
    e = cfg.max_errors
    L = idx.genome.length
    b, p, a = best.block, best.pat, best.anchor
    frame_ref = idx.genome.codes if b == K.BLOCK_FWD else rc_ref
    frame_read = read if p == K.PAT_CT else dna.revcomp(read)

    if traceback_pre is not None:
        ref_start, cigar = traceback_pre
        frame_pos = a - e + ref_start
    elif cfg.indels and align.hamming(
            frame_slice(frame_ref, a, m), frame_read) != best.score:
        window = frame_slice(frame_ref, a - e, m + 2 * e)
        dist, ref_start, cigar = align.traceback(window, frame_read)
        frame_pos = a - e + ref_start
    else:
        # frozen rule: when an ungapped alignment at the anchor achieves the
        # reported score, emit it (ties prefer no gaps) -- this is also the
        # batched finalizer's vectorized fast path (models/finalize.py)
        cigar = [("M", m)]
        frame_pos = a
    ref_span = align.cigar_ref_span(cigar)
    fwd_pos = frame_pos if b == K.BLOCK_FWD else L - frame_pos - ref_span

    ci, coord = idx.genome.pos_to_contig(fwd_pos)
    if not (0 <= coord and coord + ref_span <= int(idx.genome.lengths[ci])):
        return None  # alignment leaves its contig (frozen: reject)

    ambiguous = second is not None and second.score == best.score
    if ambiguous and not cfg.report_ambiguous:
        return None
    mapq = 0 if ambiguous else K.mapq_from_gap(
        best.score, second.score if second else None)
    if mapq_override is not None:
        mapq = mapq_override

    # SEQ follows the read's orientation (FLAG 0x10), the CIGAR the frame's
    # genome strand: they differ on the G->A frames (CTOT, CTOB)
    rev = K.IS_REVERSE[(b, p)]
    fwd_read = dna.revcomp(read) if rev else read
    cigar_fwd = list(reversed(cigar)) if b == K.BLOCK_RC else cigar
    fwd_window = frame_slice(idx.genome.codes, fwd_pos, ref_span)
    md, nm, xm = align.cigar_md_nm(fwd_window, fwd_read, 0, cigar_fwd,
                                   ga=(b == K.BLOCK_RC),
                                   genome=idx.genome.codes, gpos=fwd_pos)
    xr, xg = K.CONV_TAGS[(b, p)]
    return SamRecord(
        qname=qname,
        flag=(K.FLAG_REVERSE if rev else 0) | flag_extra,
        rname=idx.genome.names[ci],
        pos=coord + 1,
        mapq=mapq,
        cigar=align.cigar_string(cigar_fwd),
        seq=dna.decode(fwd_read),
        qual=(qual[::-1] if rev else qual) if qual else "*",
        nm=nm, md=md, xm=xm, xr=xr, xg=xg,
    )


def map_batch_se(idx: BSIndex, cfg: AlignerConfig, reads, quals=None,
                 qnames=None) -> list[SamRecord]:
    """Oracle end-to-end batch mapper -> SAM records (golden generator)."""
    rc_ref = idx.genome.rc_codes()
    quals = quals or [""] * len(reads)
    qnames = qnames or [f"r{i}" for i in range(len(reads))]
    out = []
    for read, qual, qname in zip(reads, quals, qnames):
        best, second, _ = map_read_se(idx, rc_ref, cfg, np.asarray(read))
        rec = None
        if best is not None:
            rec = finalize_hit(idx, rc_ref, cfg, np.asarray(read), qual,
                               qname, best, second)
        if rec is None:
            rec = unmapped_record(qname, read, qual)
        out.append(rec)
    return out
