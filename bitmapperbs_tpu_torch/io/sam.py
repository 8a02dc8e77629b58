"""SAM formatting and writing (SURVEY.md C18).

One formatter serves both the oracle and the device pipeline's host side, so
byte-equality between the two reduces to field-equality of the upstream
results.  Tag order is frozen: NM, MD, XM, XR, XG.

Records finalized in a pool worker cross to the main process as one
`SamText` (their lines joined, and the columns the main side reads) and come
out as `SamLine`s: a line's text with its flag, MAPQ and NM, which SamWriter
writes as it is and BamWriter parses back (`SamRecord.from_line`).
"""
from __future__ import annotations

import dataclasses
import gc
from typing import NamedTuple

import numpy as np

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.utils import dna

# the @PG record is part of the shared SAM/BAM format: both packages write
# the same header bytes
PROGRAM_ID = "bitmapperbs_tpu"
VERSION = "0.1.0"
# the tags line() writes: prefix -> field
_TAGS = {"NM:i:": "nm", "MD:Z:": "md", "XM:Z:": "xm", "XR:Z:": "xr",
         "XG:Z:": "xg"}


@dataclasses.dataclass(slots=True)
class SamRecord:
    qname: str
    flag: int
    rname: str = "*"
    pos: int = 0          # 1-based; 0 = unmapped
    mapq: int = 0
    cigar: str = "*"
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    nm: int | None = None
    md: str | None = None
    xm: str | None = None
    xr: str | None = None
    xg: str | None = None

    def line(self) -> str:
        fields = [
            self.qname, str(self.flag), self.rname, str(self.pos),
            str(self.mapq), self.cigar, self.rnext, str(self.pnext),
            str(self.tlen), self.seq, self.qual,
        ]
        if self.nm is not None:
            fields.append(f"NM:i:{self.nm}")
        if self.md is not None:
            fields.append(f"MD:Z:{self.md}")
        if self.xm is not None:
            fields.append(f"XM:Z:{self.xm}")
        if self.xr is not None:
            fields.append(f"XR:Z:{self.xr}")
        if self.xg is not None:
            fields.append(f"XG:Z:{self.xg}")
        return "\t".join(fields)

    @classmethod
    def from_line(cls, line: str) -> "SamRecord":
        """The record whose line() is `line`."""
        f = line.split("\t")
        rec = cls(f[0], int(f[1]), f[2], int(f[3]), int(f[4]), f[5], f[6],
                  int(f[7]), int(f[8]), f[9], f[10])
        for tag in f[11:]:
            name = _TAGS.get(tag[:5])
            if name is None:
                raise ValueError(f"unknown SAM tag {tag[:5]!r} in {f[0]!r}")
            setattr(rec, name, int(tag[5:]) if name == "nm" else tag[5:])
        return rec


class SamLine:
    """A record as its SAM line, with the fields that MapStats and the
    CLI's --unmapped-out / --ambiguous-out read."""

    __slots__ = ("text", "flag", "mapq", "nm")

    def __init__(self, text: str, flag: int, mapq: int, nm: int | None):
        self.text, self.flag, self.mapq, self.nm = text, flag, mapq, nm

    def line(self) -> str:
        return self.text


class SamText(NamedTuple):
    """A list of records packed to cross a process boundary: their line()s
    joined by newlines, and flag, MAPQ and NM (None as -1) as int32
    columns."""

    text: str
    flag: np.ndarray
    mapq: np.ndarray
    nm: np.ndarray

    @classmethod
    def pack(cls, recs) -> "SamText":
        return cls("\n".join([r.line() for r in recs]),
                   np.array([r.flag for r in recs], dtype=np.int32),
                   np.array([r.mapq for r in recs], dtype=np.int32),
                   np.array([-1 if r.nm is None else r.nm for r in recs],
                            dtype=np.int32))

    def lines(self) -> list[SamLine]:
        """The records as SamLines, in their order.  The cyclic garbage
        collector is paused while they are made: a SamLine refers to no
        other container, so no cycle is missed, and thousands of new
        objects a batch would otherwise set off a full collection of the
        whole process every few batches."""
        if not len(self.flag):
            return []
        texts = self.text.split("\n")
        if len(texts) != len(self.flag):
            raise ValueError(f"{len(texts)} SAM lines for "
                             f"{len(self.flag)} records")
        collecting = gc.isenabled()
        gc.disable()
        try:
            nms = [None if v < 0 else v for v in self.nm.tolist()]
            return list(map(SamLine, texts, self.flag.tolist(),
                            self.mapq.tolist(), nms))
        finally:
            if collecting:
                gc.enable()


def header(names, lengths, rg: str | None = None,
           cl: str = PROGRAM_ID) -> list[str]:
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    for n, ln in zip(names, lengths):
        lines.append(f"@SQ\tSN:{n}\tLN:{int(ln)}")
    if rg:
        lines.append(f"@RG\tID:{rg}")
    lines.append(f"@PG\tID:{PROGRAM_ID}\tPN:{PROGRAM_ID}\tVN:{VERSION}\tCL:{cl}")
    return lines


def unmapped_record(qname: str, read_codes, qual: str,
                    flag_extra: int = 0) -> SamRecord:
    return SamRecord(
        qname=qname, flag=K.FLAG_UNMAPPED | flag_extra,
        seq=dna.decode(read_codes), qual=qual or "*",
    )


class SamWriter:
    """Ordered SAM writer (reference parity: C18 ordered output)."""

    def __init__(self, fh, names, lengths, rg=None, cl=PROGRAM_ID):
        self.fh = fh
        for line in header(names, lengths, rg, cl):
            fh.write(line + "\n")

    def write(self, rec: SamRecord | SamLine) -> None:
        self.fh.write(rec.line() + "\n")

    def flush(self) -> None:
        """Checkpoint point: after this, fh.tell() is a record boundary."""
        self.fh.flush()
