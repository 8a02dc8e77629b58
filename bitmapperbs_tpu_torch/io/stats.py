"""Run statistics (SURVEY.md C20): mapped/unique/ambiguous/unmapped counters,
error histogram, capacity-overflow count, end-of-run report."""
from __future__ import annotations

import dataclasses
import json
import sys

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.io.sam import SamLine, SamRecord


@dataclasses.dataclass
class MapStats:
    total: int = 0
    mapped: int = 0
    unique: int = 0
    ambiguous: int = 0          # reported with MAPQ 0
    unmapped: int = 0
    proper_pairs: int = 0       # record-level count
    overflow_reads: int = 0     # candidate-capacity truncations (critical:
                                # silent caps eat recall -- SURVEY.md 5.5)
    nm_hist: dict = dataclasses.field(default_factory=dict)

    def add_record(self, rec: SamRecord | SamLine) -> None:
        self.total += 1
        if rec.flag & K.FLAG_UNMAPPED:
            self.unmapped += 1
            return
        self.mapped += 1
        if rec.mapq == 0:
            self.ambiguous += 1
        else:
            self.unique += 1
        if rec.flag & K.FLAG_PROPER:
            self.proper_pairs += 1
        if rec.nm is not None:
            self.nm_hist[rec.nm] = self.nm_hist.get(rec.nm, 0) + 1

    def merge(self, other: "MapStats") -> None:
        for f in ("total", "mapped", "unique", "ambiguous", "unmapped",
                  "proper_pairs", "overflow_reads"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for k, v in other.nm_hist.items():
            self.nm_hist[k] = self.nm_hist.get(k, 0) + v

    def report(self, fh=None, wall_s: float | None = None) -> None:
        fh = fh if fh is not None else sys.stderr  # resolve at call time
        pct = lambda x: f"{100.0 * x / max(self.total, 1):.2f}%"
        fh.write(
            f"[bitmapperbs_tpu_torch] reads: {self.total}  "
            f"mapped: {self.mapped} ({pct(self.mapped)})  "
            f"unique: {self.unique} ({pct(self.unique)})  "
            f"ambiguous: {self.ambiguous}  unmapped: {self.unmapped}  "
            f"proper: {self.proper_pairs}  overflow: {self.overflow_reads}\n")
        if wall_s:
            fh.write(f"[bitmapperbs_tpu_torch] {self.total / wall_s:.0f} reads/s "
                     f"({wall_s:.1f}s)\n")

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["nm_hist"] = {str(k): v for k, v in sorted(self.nm_hist.items())}
        return json.dumps(d)
