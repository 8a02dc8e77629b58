"""The plain reference that decides `correct`: numpy only, nothing of the
program.  `map_reads` / `map_pairs` give the SAM records that the spec says
the sampled reads must get."""
from __future__ import annotations

import numpy as np

from wgbs_bench.reference.paired import map_batch_pe
from wgbs_bench.reference.pipeline import map_batch_se


def map_reads(index, spec, reads, qnames) -> list[str]:
    """SAM lines of single-end reads (code arrays), one per read."""
    return [r.line() for r in map_batch_se(
        index, spec, [np.asarray(r) for r in reads],
        ["I" * len(r) for r in reads], list(qnames))]


def map_pairs(index, spec, pairs, qnames) -> list[str]:
    """SAM lines of pairs, two per pair (mate 1, mate 2)."""
    return [r.line() for r in map_batch_pe(
        index, spec, pairs, [("I" * len(a), "I" * len(b)) for a, b in pairs],
        list(qnames))]
