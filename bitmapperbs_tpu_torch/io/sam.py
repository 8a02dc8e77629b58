"""SAM formatting and writing (SURVEY.md C18).

One formatter serves both the oracle and the device pipeline's host side, so
byte-equality between the two reduces to field-equality of the upstream
results.  Tag order is frozen: NM, MD, XM, XR, XG.
"""
from __future__ import annotations

import dataclasses

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.utils import dna

# the @PG record is part of the shared SAM/BAM format: both packages write
# the same header bytes
PROGRAM_ID = "bitmapperbs_tpu"
VERSION = "0.1.0"


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

    def write(self, rec: SamRecord) -> None:
        self.fh.write(rec.line() + "\n")

    def flush(self) -> None:
        """Checkpoint point: after this, fh.tell() is a record boundary."""
        self.fh.flush()
