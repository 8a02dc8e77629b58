"""The spec's parameters of a deployment, as its configuration file states
them (`spec`), independent of how the program builds its own config."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Spec:
    max_errors: int
    indels: bool
    non_directional: bool
    paired: bool
    min_insert: int
    max_insert: int
    max_seed_occ: int
    locate_budget: int
    max_candidates: int
    seed_ext_max: int
    seed_ext_occ: int
    mapq_by_gap: list         # MAPQ by the gap from the best score to the
    mapq_max: int             # second best; past the list, or no second
    report_ambiguous: bool = True

    @property
    def num_seeds(self) -> int:
        return self.max_errors + 1

    def replace(self, **kw) -> "Spec":
        return dataclasses.replace(self, **kw)
