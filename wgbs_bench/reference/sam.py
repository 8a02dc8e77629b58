"""The SAM record and its line (SAM v1 1.4: the eleven fields, tab-separated,
then the tags in the configurations' order NM, MD, XM, XR, XG)."""
from __future__ import annotations

import dataclasses

from wgbs_bench.reference import constants as K
from wgbs_bench.reference import dna

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


def unmapped_record(qname: str, read_codes, qual: str) -> SamRecord:
    return SamRecord(
        qname=qname, flag=K.FLAG_UNMAPPED,
        seq=dna.decode(read_codes), qual=qual or "*",
    )
