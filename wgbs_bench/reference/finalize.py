"""The SAM records of a selected hit, worked out from the SAM v1 and Bismark
definitions, apart from any aligner's code.

Given the hit that selection chose (its frame, anchor and score), the read
is aligned to the genome window in the frame it matched in, and the record
follows from what the fields mean:

- the alignment: the read end to end against the window [anchor - e,
  anchor + m + e) of the frame's strand, free at both window ends, a base
  matching when equal or when the genome has C and the read T (bisulfite);
  N matches nothing.  If the hit's score is the ungapped mismatch count at
  the anchor, the ungapped alignment is taken.  Otherwise the least edits,
  the alignment ending at the leftmost best end column and traced back
  preferring a match or mismatch, then a deletion, then an insertion (the
  configurations' stated tie-break).
- the record is on the forward strand of the genome (SAM v1 1.4): a hit on
  the reverse strand's frame has its alignment reversed, POS counted from
  the forward start of the aligned bases; SEQ is the read as the forward
  strand reads it, reverse-complemented (FLAG 0x10, QUAL reversed) where
  that differs from the read as sequenced.
- NM and MD (SAM tags 1.5) from walking that CIGAR over the genome at POS:
  an insertion or deletion counts its bases; a mismatch counts one, where
  the strand's bisulfite change (C->T on the forward frame, G->A seen from
  the forward strand on the reverse one) is no mismatch.
- XM, XR, XG as Bismark defines them: a methylation call per SEQ base at a
  genome cytosine of the strand (Z/z CpG, X/x CHG, H/h CHH, U/u unknown
  context, upper case kept as C), `.` elsewhere; XR the read's conversion
  (CT for the read's own C->T search, GA for its reverse complement's), XG
  the genome strand's (CT forward, GA reverse).
- MAPQ from the configuration's table of score gaps to the second best.
- Paired reads (SAM v1 1.4): RNEXT / PNEXT the mate's RNAME / POS (`=` on
  the same contig), FLAG bits 0x1, 0x2, 0x8, 0x20, 0x40 / 0x80 by their
  definitions, TLEN from the leftmost to the rightmost mapped base of the
  two on one contig, plus on the leftmost mate (mate 1 at equal POS), 0
  otherwise.  An unmapped mate keeps RNAME `*`, POS 0.
"""
from __future__ import annotations

import numpy as np

from wgbs_bench.reference import constants as K
from wgbs_bench.reference import dna
from wgbs_bench.reference.sam import SamRecord

BASES = "ACGTN"


def _matches(ref: int, read: int, bottom: bool) -> bool:
    """One base pair of the alignment, on the forward strand's view:
    C->T converted on the top strand, G->A on the bottom strand."""
    if ref == K.N_CODE or read == K.N_CODE:
        return False
    if ref == read:
        return True
    return (ref, read) == ((K.G, K.A) if bottom else (K.C, K.T))


def window(strand: np.ndarray, start: int, length: int) -> list[int]:
    """strand[start:start + length], N outside the strand."""
    n = len(strand)
    return [int(strand[p]) if 0 <= p < n else K.N_CODE
            for p in range(start, start + length)]


def align_end_to_end(ref: list[int], read: list[int]):
    """The read end to end against a stretch of genome, free at both ends of
    the stretch; (start in the stretch, ops), ops a list of "M" / "I" / "D"
    (I: a read base with no genome base; D: a genome base with no read
    base), by the stated end column and tie-break."""
    m, w = len(read), len(ref)
    cost = [[0] * (w + 1) for _ in range(m + 1)]
    for i in range(1, m + 1):
        row, up = cost[i], cost[i - 1]
        row[0] = i
        r = read[i - 1]
        for j in range(1, w + 1):
            best = up[j - 1] + (0 if _matches(ref[j - 1], r, False) else 1)
            if up[j] + 1 < best:
                best = up[j] + 1
            if row[j - 1] + 1 < best:
                best = row[j - 1] + 1
            row[j] = best
    j = cost[m].index(min(cost[m]))
    i, ops = m, []
    while i > 0:
        here = cost[i][j]
        if j > 0 and here == cost[i - 1][j - 1] + (
                0 if _matches(ref[j - 1], read[i - 1], False) else 1):
            ops.append("M")
            i, j = i - 1, j - 1
        elif j > 0 and here == cost[i][j - 1] + 1:
            ops.append("D")
            j -= 1
        else:
            ops.append("I")
            i -= 1
    ops.reverse()
    while ops and ops[0] == "D":        # a gap at either end is no edit:
        ops.pop(0)                      # the stretch is free there
        j += 1
    while ops and ops[-1] == "D":
        ops.pop()
    return j, ops


def runs(ops: list[str]) -> list[tuple[str, int]]:
    out: list[list] = []
    for op in ops:
        if out and out[-1][0] == op:
            out[-1][1] += 1
        else:
            out.append([op, 1])
    return [(op, n) for op, n in out]


def frame_alignment(strand: np.ndarray, frame_read: np.ndarray, hit,
                    spec) -> tuple[int, list[tuple[str, int]]]:
    """(start on the frame's strand, CIGAR runs in the frame's direction)."""
    m, e = len(frame_read), spec.max_errors
    read = [int(x) for x in frame_read]
    at = window(strand, hit.anchor, m)
    if not spec.indels or sum(
            not _matches(a, b, False) for a, b in zip(at, read)) == hit.score:
        return hit.anchor, [("M", m)]
    start, ops = align_end_to_end(window(strand, hit.anchor - e, m + 2 * e),
                                  read)
    return hit.anchor - e + start, runs(ops)


def context(genome: np.ndarray, q: int, bottom: bool) -> str:
    """Bismark's context letter of the cytosine at forward position q (on
    the bottom strand: the G there): z CpG, x CHG, h CHH, u unknown."""
    step, partner = (-1, K.C) if bottom else (1, K.G)
    nxt = [int(genome[p]) if 0 <= p < len(genome) else K.N_CODE
           for p in (q + step, q + 2 * step)]
    if nxt[0] == partner:
        return "z"
    if nxt[0] == K.N_CODE:
        return "u"
    if nxt[1] == partner:
        return "x"
    if nxt[1] == K.N_CODE:
        return "u"
    return "h"


def walk(genome: np.ndarray, pos: int, seq: list[int],
         cigar: list[tuple[str, int]], bottom: bool) -> tuple[int, str, str]:
    """NM, MD and XM of SEQ aligned at forward position pos by cigar."""
    nm, md, run, xm = 0, [], 0, []
    cyt = K.G if bottom else K.C
    q, i = pos, 0
    for op, n in cigar:
        if op == "D":
            nm += n
            md.append(f"{run}^" + "".join(BASES[int(genome[q + t])]
                                         for t in range(n)))
            run, q = 0, q + n
        elif op == "I":
            nm += n
            xm.append("." * n)
            i += n
        else:
            for _ in range(n):
                g, r = int(genome[q]), seq[i]
                if not _matches(g, r, bottom):
                    nm += 1
                    md.append(f"{run}{BASES[g]}")
                    run = 0
                    xm.append(".")
                elif g == cyt:
                    c = context(genome, q, bottom)
                    xm.append(c.upper() if r == cyt else c)
                    run += 1
                else:
                    xm.append(".")
                    run += 1
                q, i = q + 1, i + 1
    md.append(str(run))
    return nm, "".join(md), "".join(xm)


def mapq(spec, best: int, second: int | None) -> int:
    """The configuration's table: a tie at the best score 0, else by the
    gap to the second best; no second best, or a gap past the table, the
    maximum."""
    if second is None:
        return spec.mapq_max
    gap = second - best
    if gap >= len(spec.mapq_by_gap):
        return spec.mapq_max
    return spec.mapq_by_gap[max(gap, 0)]


def hit_record(genome, spec, read: np.ndarray, qual: str, qname: str, hit,
               mq: int) -> SamRecord | None:
    """The record of `read` aligned at `hit`; None where the aligned bases
    leave their contig."""
    L = genome.length
    bottom = hit.block == K.BLOCK_RC
    strand = genome.rc_codes() if bottom else genome.codes
    frame_read = read if hit.pat == K.PAT_CT else dna.revcomp(read)
    start, cigar = frame_alignment(strand, frame_read, hit, spec)
    span = sum(n for op, n in cigar if op in "MD")
    if bottom:                  # the frame runs against the forward strand
        pos = L - start - span
        cigar = cigar[::-1]
        seq = dna.revcomp(frame_read)
    else:
        pos, seq = start, frame_read
    ci, coord = genome.pos_to_contig(pos)
    if coord < 0 or coord + span > int(genome.lengths[ci]):
        return None
    reverse = (hit.pat == K.PAT_GA) != bottom   # SEQ is the read's reverse
    nm, md, xm = walk(genome.codes, pos, [int(x) for x in seq], cigar,
                      bottom)
    return SamRecord(
        qname=qname, flag=K.FLAG_REVERSE if reverse else 0,
        rname=genome.names[ci], pos=coord + 1, mapq=mq,
        cigar="".join(f"{n}{op}" for op, n in cigar), seq=dna.decode(seq),
        qual=(qual[::-1] if reverse else qual) if qual else "*",
        nm=nm, md=md, xm=xm,
        xr="CT" if hit.pat == K.PAT_CT else "GA",
        xg="GA" if bottom else "CT")


def ref_span(rec: SamRecord) -> int:
    """Genome bases a record's CIGAR covers."""
    num, span = "", 0
    for ch in rec.cigar:
        if ch.isdigit():
            num += ch
        else:
            span += int(num) if ch in "MD=X" else 0
            num = ""
    return span


def mate_fields(r1: SamRecord, r2: SamRecord) -> None:
    """RNEXT, PNEXT and TLEN of two mapped mates, in place."""
    for a, b in ((r1, r2), (r2, r1)):
        a.rnext = "=" if a.rname == b.rname else b.rname
        a.pnext = b.pos
    if r1.rname != r2.rname:
        r1.tlen = r2.tlen = 0
        return
    left = min(r1.pos, r2.pos)
    right = max(r1.pos + ref_span(r1), r2.pos + ref_span(r2))
    first = r1 if r1.pos <= r2.pos else r2
    other = r2 if first is r1 else r1
    first.tlen, other.tlen = right - left, left - right
