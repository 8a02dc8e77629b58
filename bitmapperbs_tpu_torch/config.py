"""AlignerConfig: one frozen, hashable config object (SURVEY.md section 5.6;
counterpart of bitmapperbs_tpu/config.py, field for field).

One dataclass carries every threshold and capacity; the CLI maps 1:1 onto
it.  Fields that only the reference's device code reads (use_pallas,
mesh_*) are kept, so a reference config converts field by field
(`from_reference`).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AlignerConfig:
    # --- error model -------------------------------------------------------
    max_errors: int = 4          # -e : edit-distance budget per read
    indels: bool = True          # False -> Hamming-only fast path (config 1)

    # --- seeding policy (frozen spec: pigeonhole e+1 equal slices) ---------
    # Defaults re-tuned round 2 on the 100 Mbp benchmark: raising the caps
    # from (64, 64, 32) recovers most heavy-seed recall loss (0.9775 ->
    # 0.9900) at UNCHANGED throughput, because the compact pipeline's cost
    # is set by the flat-buffer size (resolve_flat_cap), not these budgets.
    max_seed_occ: int = 128      # seed interval wider than this is skipped
    locate_budget: int = 256     # SA entries located per read per (pat,block)
    max_candidates: int = 64     # verified anchors per read per (pat,block)
    # Adaptive seed extension (SURVEY.md C9 "extend until rare"): a seed
    # whose interval holds more than seed_ext_occ occurrences keeps
    # prepending read characters left of its pigeonhole slice -- up to
    # seed_ext_max of them, stopping at the read start or when one more
    # character would empty the interval (the seed keeps its last nonempty
    # interval and stops).  Essential at Gbp scale where the 3-letter
    # alphabet makes T-rich 18-mers heavy-tailed: without it mean occupancy
    # ~259 entries/read at 3.08 Gbp floods every downstream cap (measured:
    # recall 0.59 at the default caps).  0 = off (<= 100 Mbp genomes are
    # cheap enough to just locate/verify the junk).
    seed_ext_max: int = 0
    seed_ext_occ: int = 4   # the measured 3 Gbp operating point (PERF.md);
    #                         matches the CLI default and autotune

    # --- library protocol --------------------------------------------------
    non_directional: bool = False  # --pbat / non-directional: add PAT_GA
    paired: bool = False
    min_insert: int = 0
    max_insert: int = 1000

    # --- batching ----------------------------------------------------------
    batch_size: int = 4096       # reads per device batch (per shard)
    read_len_bucket: int = 160   # padded read length (SURVEY hard-part 4)

    # --- device / parallelism ---------------------------------------------
    mesh_shape: tuple[int, ...] = (1,)
    mesh_axes: tuple[str, ...] = ("data",)
    use_pallas: bool = True      # read by the reference package only

    # --- compacted candidate pipeline ---------------------------------------
    # The locate/verify stages run over a flat buffer holding only OCCUPIED
    # candidate slots (batch-wide), instead of dense (B, F, budget) grids
    # sized for the worst case -- measured ~20x slot waste on typical reads.
    # Results are bit-identical to the dense path unless the flat buffer
    # overflows (reported per read as `gdrop`; the host then re-runs those
    # reads through the dense path, keeping output deterministic).
    compact: bool = True
    # flat slots per read (buffer = batch * this).  0 = genome-size adaptive:
    # candidate counts grow ~linearly with genome size (the 3-letter
    # converted alphabet makes seeds T-rich and heavy-tailed), so small
    # genomes get a tight buffer and large ones grow toward flat_cap_max.
    locate_flat_cap: int = 0
    # Ceiling on the ADAPTIVE flat cap: the locate/dedup/verify stages cost
    # O(batch * flat_cap) gathers whether slots are occupied or not, so the
    # buffer must track expected occupancy, not the worst-case per-frame
    # budget (F * locate_budget) -- overflow reads fall back to the dense
    # spec path via gdrop instead.  128 keeps the human-genome buffer at
    # its measured round-1 size while the per-frame budgets above grew 4x.
    flat_cap_max: int = 128
    # The reference's occupancy-chunked flat stages (locate/verify in this
    # many lane chunks, stopping after the last occupied slot; 0 = off).
    # The port accepts it for the reference CLI's sake and ignores it:
    # locate and verify always stop at the flat buffer's fill on the card
    # (ops/kernels.flat_expand's n_used, flat_dedup's n_valid).
    flat_chunks: int = 0

    def resolve_flat_cap(self, genome_len: int, num_frames: int) -> int:
        hard = num_frames * self.locate_budget   # per-read entries never exceed
        if self.locate_flat_cap > 0:
            return min(self.locate_flat_cap, hard)
        # Fitted to measured mean occupancy (PERF.md round-2 cap tuning):
        # 6.5 entries/read at 10 Mbp, 29.4 at 100 Mbp -> occupancy ~
        # (len/1M)^0.66; cap at ~1.5x the mean leaves gdrop-free headroom
        # while cutting the idle-lane locate/verify gather volume that a
        # round-up cap was paying.
        # num_frames scales occupancy ~linearly (non-directional = 4 frames
        # = ~2x the entries of directional's 2; measured: PBAT at 100 Mbp
        # gdropped 43% of reads under the 2-frame cap)
        est = int(np.ceil((genome_len / 1e6) ** 0.66 * num_frames))
        return int(np.clip(est, 10, min(hard, self.flat_cap_max)))

    # --- output ------------------------------------------------------------
    report_ambiguous: bool = True   # emit MAPQ-0 record vs suppress
    sam_rg: str | None = None

    @property
    def num_seeds(self) -> int:
        return self.max_errors + 1

    @property
    def band(self) -> int:
        """Myers band half-width == max_errors; full band 2e+1 columns."""
        return self.max_errors

    def replace(self, **kw) -> "AlignerConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_reference(cls, cfg) -> "AlignerConfig":
        """A reference-package AlignerConfig (same fields) -> this class."""
        return cls(**dataclasses.asdict(cfg))

    def validate(self) -> None:
        if self.max_errors < 0 or self.max_errors > 15:
            raise ValueError("max_errors must be in [0, 15]")
        if self.paired and self.min_insert > self.max_insert:
            raise ValueError("min_insert > max_insert")
        if self.read_len_bucket % 32 != 0:
            raise ValueError("read_len_bucket must be a multiple of 32")
        if self.locate_flat_cap < 0:
            raise ValueError("locate_flat_cap must be >= 0 (0 = auto)")
        if self.seed_ext_max < 0 or self.seed_ext_occ < 1:
            raise ValueError("seed_ext_max must be >= 0 and "
                             "seed_ext_occ >= 1")
