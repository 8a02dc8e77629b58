"""The JAX package's SAM records in their SAM v1 form, for the tests that hold
the port's SAM to the JAX package's.

The JAX package (not edited) writes two kinds of record that SAM v1 defines
otherwise, and the port writes them as SAM v1 does:

- a G->A-read hit (XR:Z:GA) with an insertion or deletion: the JAX package
  reverses the frame's CIGAR by FLAG 0x10 where SAM v1 orders it along the
  forward genome strand, which is the frame's genome strand reversed on
  block 1; it then walks NM / MD / XM along the wrong CIGAR.  For every
  XR:Z:GA record the two orders are each other's reverse;
- a pair's mate fields: RNEXT / PNEXT of an unmapped mate, TLEN of two mates
  on one contig that are not a proper pair, and a TLEN that must end at the
  rightmost mapped base of the two.

`sam_v1` rewrites those fields, and only those, with the benchmark's
independent reference (`wgbs_bench/reference/finalize.py`: `walk` and
`mate_fields`), none of the port's code, and keeps every other record and
field byte for byte.  It returns how many records it changed, so that a
test whose data holds such records can assert the rewrite was needed.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from wgbs_bench.reference import finalize as ref_finalize
from wgbs_bench.reference.sam import SamRecord as RefRecord

BASES = "ACGTN"
FLAG_UNMAPPED = 0x4
MATE_FIELDS = slice(6, 9)           # RNEXT, PNEXT, TLEN


def _runs(cigar: str) -> list[tuple[str, int]]:
    out, num = [], ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((ch, int(num)))
            num = ""
    return out


def _ga_gapped(f: list[str]) -> bool:
    return "XR:Z:GA" in f[11:] and any(op in f[5] for op in "ID")


def _mend_ga_gapped(f: list[str], genome) -> None:
    """The CIGAR of an XR:Z:GA record with an indel reversed, and NM / MD /
    XM walked again over the genome along it, in place."""
    cigar = _runs(f[5])[::-1]
    pos = int(genome.offsets[list(genome.names).index(f[2])]) + int(f[3]) - 1
    seq = [BASES.index(c) for c in f[9]]
    nm, md, xm = ref_finalize.walk(np.asarray(genome.codes), pos, seq, cigar,
                                   "XG:Z:GA" in f[11:])
    f[5] = "".join(f"{n}{op}" for op, n in cigar)
    new = {"NM:i:": str(nm), "MD:Z:": md, "XM:Z:": xm}
    f[11:] = [t[:5] + new[t[:5]] if t[:5] in new else t for t in f[11:]]


def mend_mates(f1: list[str], f2: list[str]) -> None:
    """RNEXT / PNEXT / TLEN of a pair's two records as the reference sets
    them, in place."""
    recs = [RefRecord(qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]),
                      cigar=f[5]) for f in (f1, f2)]
    unmapped = [bool(r.flag & FLAG_UNMAPPED) for r in recs]
    if not any(unmapped):
        ref_finalize.mate_fields(*recs)
    elif not all(unmapped):
        r, mate = recs if unmapped[0] else recs[::-1]
        r.rnext, r.pnext = mate.rname, mate.pos
    for f, r in zip((f1, f2), recs):
        f[MATE_FIELDS] = [r.rnext, str(r.pnext), str(r.tlen)]


def sam_v1(lines, genome, paired: bool) -> tuple[list[str], int]:
    """(the JAX package's SAM `lines` in SAM v1 form, records changed).

    `lines`: SAM lines without their newline; header lines (`@`) are kept.
    `genome`: the index's genome (names, offsets, padded codes).  `paired`:
    the records are pairs, mate 1 then mate 2 of one QNAME."""
    out, fields = [], []
    for line in lines:
        if line.startswith("@"):
            out.append(line)
            continue
        f = line.split("\t")
        if _ga_gapped(f):
            _mend_ga_gapped(f, genome)
        out.append(None)
        fields.append((len(out) - 1, f))
    if paired:
        if len(fields) % 2:
            raise ValueError("paired records come two by two")
        for (_, f1), (_, f2) in zip(fields[::2], fields[1::2]):
            if f1[0] != f2[0] or not (int(f1[1]) & 0x40 and int(f2[1]) & 0x80):
                raise ValueError(f"not mates: {f1[0]} {f2[0]}")
            mend_mates(f1, f2)
    for k, f in fields:
        out[k] = "\t".join(f)
    changed = sum(a != b for a, b in zip(lines, out))
    return out, changed


def _nm(line: str) -> int | None:
    tag = [t for t in line.split("\t")[11:] if t.startswith("NM:i:")]
    return int(tag[0][5:]) if tag else None


def restat(stats_json: str, before, after) -> str:
    """A MapStats JSON (io/stats.MapStats.to_json) of the records `before`,
    as the records `after` (sam_v1's lines of them) give it: the NM
    histogram moved record by record, since NM is the one field it counts
    that sam_v1 changes."""
    d = json.loads(stats_json)
    hist = {int(k): v for k, v in d["nm_hist"].items()}
    for a, b in zip(before, after):
        if a == b:
            continue
        for line, step in ((a, -1), (b, 1)):
            nm = _nm(line)
            if nm is not None and not int(line.split("\t")[1]) & FLAG_UNMAPPED:
                hist[nm] = hist.get(nm, 0) + step
    d["nm_hist"] = {str(k): v for k, v in sorted(hist.items()) if v}
    return json.dumps(d) + stats_json[len(stats_json.rstrip("\n")):]


def sam_v1_records(recs, genome, paired: bool, from_line
                   ) -> tuple[list, int]:
    """sam_v1 of record objects (anything with line()): the records of the
    rewritten lines, made by `from_line`, each kept as it was where its line
    did not change."""
    lines = [r.line() for r in recs]
    out, changed = sam_v1(lines, genome, paired)
    return [r if a == b else from_line(b)
            for r, a, b in zip(recs, lines, out)], changed


def jax_record(port_record_cls, jax_record_cls):
    """A from_line for the JAX package's SamRecord, which has none: the
    port's SamRecord.from_line turned into the JAX package's class."""
    def from_line(line: str):
        return jax_record_cls(**dataclasses.asdict(
            port_record_cls.from_line(line)))
    return from_line
