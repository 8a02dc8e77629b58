"""The reference genome of a configuration, made from its `genome` spec.

A deployment aligns against one reference, so the genome comes from the
configuration's own `genome_seed`, never from `--seed`.  The generator is a
frozen copy of the port's `utils/simulate.plant_repeats` and the codes that
`repeat_genome_fasta` draws (a random backbone at the stated GC share, then
human-profile repeat families, satellite arrays and segmental duplications
planted in place), so the yardstick stays put when the program changes.

The contigs' codes and the planted-interval record are cached under
`.cache/` by the spec's hash: only the first run of a checkout draws them.
"""
from __future__ import annotations

import json
import os

import numpy as np

from wgbs_bench import cache

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def plant_repeats(rng, codes: np.ndarray, *, dispersed_frac: float = 0.27,
                  line_frac: float = 0.17, tandem_frac: float = 0.03,
                  segdup_frac: float = 0.05, divergence=(0.05, 0.15),
                  record: list | None = None) -> None:
    """Overwrite a random backbone with human-like repeat structure, in
    place: SINE-like (300 bp) and LINE-like (6 kb, 5'-truncated) copies of
    per-family consensi at 85-95 % identity, tandem arrays of 2-171 bp units,
    segmental duplications at 95-99 %.  `record` gets every planted interval
    as (start, end, kind) and costs no draw."""
    L = len(codes)

    def _mutate(seq, rate):
        m = rng.random(len(seq)) < rate
        out = seq.copy()
        out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
        return out

    for frac, unit, fams, key in ((dispersed_frac, 300, 8, "dispersed"),
                                  (line_frac, 6000, 4, "line")):
        total = int(L * frac)
        if total < unit:
            continue
        n_copies = max(1, total // unit)
        consensi = [rng.integers(0, 4, unit).astype(np.uint8)
                    for _ in range(fams)]
        fam = rng.integers(0, fams, n_copies)
        pos = rng.integers(0, max(1, L - unit), n_copies)
        div = rng.uniform(divergence[0], divergence[1], n_copies)
        tr = (rng.integers(0, unit - 50, n_copies)
              if unit > 1000 else np.zeros(n_copies, dtype=np.int64))
        for i in range(n_copies):
            c = _mutate(consensi[fam[i]][tr[i]:], div[i])
            codes[pos[i]:pos[i] + len(c)] = c[:L - pos[i]]
            if record is not None:
                record.append((int(pos[i]),
                               int(pos[i]) + min(len(c), L - int(pos[i])),
                               key))

    total = int(L * tandem_frac)
    placed = 0
    while placed < total:
        u = int(rng.choice([2, 4, 6, 20, 171]))
        unit = rng.integers(0, 4, u).astype(np.uint8)
        arr_len = int(min(rng.integers(u * 10, 50_000), total - placed))
        if arr_len < u * 2:
            break
        reps = -(-arr_len // u)
        arr = _mutate(np.tile(unit, reps)[:arr_len], 0.02)
        p = int(rng.integers(0, max(1, L - arr_len)))
        codes[p:p + arr_len] = arr[:L - p]
        placed += arr_len
        if record is not None:
            record.append((p, p + min(arr_len, L - p), "tandem"))

    total = int(L * segdup_frac)
    placed = 0
    while placed < total:
        seg = int(min(rng.integers(500_000, 5_000_000), total - placed))
        if seg < 100_000 or L < 2 * seg:
            break
        src = int(rng.integers(0, L - seg))
        dst = int(rng.integers(0, L - seg))
        codes[dst:dst + seg] = _mutate(codes[src:src + seg],
                                       float(rng.uniform(0.01, 0.05)))
        placed += seg
        if record is not None:
            record.append((src, src + seg, "segdup"))
            record.append((dst, dst + seg, "segdup"))


class Genome:
    """The contigs as drawn (codes 0-3, no padding), their names, and the
    planted intervals of each contig."""

    def __init__(self, names, contigs, records):
        self.names = list(names)
        self.contigs = list(contigs)
        self.records = list(records)

    @property
    def bp(self) -> int:
        return sum(len(c) for c in self.contigs)

    def fasta(self) -> str:
        """The genome as FASTA text, one line per contig."""
        return "".join(f">{n}\n{BASES[c].tobytes().decode()}\n"
                       for n, c in zip(self.names, self.contigs))


def draw(spec: dict) -> Genome:
    """Draws the genome of a `genome` spec: {"contigs": [bp, ...], "gc",
    "genome_seed", "repeats": bool}."""
    rng = np.random.default_rng(int(spec["genome_seed"]))
    gc = float(spec["gc"])
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    contigs, records = [], []
    for ln in spec["contigs"]:
        codes = rng.choice(4, size=int(ln), p=p).astype(np.uint8)
        rec: list = []
        if spec.get("repeats", True):
            plant_repeats(rng, codes, record=rec)
        contigs.append(codes)
        records.append(rec)
    names = [f"chr{i + 1}" for i in range(len(contigs))]
    return Genome(names, contigs, records)


def load(spec: dict) -> tuple[Genome, float]:
    """The genome of `spec` from the cache, drawn and stored there first if
    missing; and the seconds spent drawing it (0 on a hit)."""
    import time

    d = cache.entry("genome", spec)
    meta = os.path.join(d, "genome.json")
    if os.path.exists(meta):
        with open(meta) as f:
            m = json.load(f)
        contigs = [np.load(os.path.join(d, f"contig{i}.npy"), mmap_mode="r")
                   for i in range(len(m["names"]))]
        return Genome(m["names"], contigs, m["records"]), 0.0
    t0 = time.perf_counter()
    g = draw(spec)
    tmp = cache.staging(d)
    for i, c in enumerate(g.contigs):
        np.save(os.path.join(tmp, f"contig{i}.npy"), c)
    with open(os.path.join(tmp, "genome.json"), "w") as f:
        json.dump({"names": g.names, "records": g.records}, f)
    cache.commit(tmp, d)
    return g, time.perf_counter() - t0
