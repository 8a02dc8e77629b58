"""The one traffic generator: a traffic file's parameters and the genome ->
the cell's read pool, drawn from `--seed`, and its FASTQ file(s).

A traffic file (`traffic/<name>.json`) holds:

  mode          "se" or "pe"
  pool          reads (SE) or pairs (PE) in the pool, a whole number of the
                host loop's calls (the window cycles through the pool)
  read_len      sequenced bases per read (after the 5' clip)
  clip5         bases clipped off the 5' end (0: none)
  protocols     strands of the genomic reads: "OT", "OB", "CTOT", "CTOB"
                (PE draws FR pairs from OT / OB fragments)
  insert        [lo, hi] fragment lengths of the pairs (PE)
  meth          {"cpg": p, "other": p}: chance a C stays C, by context
  sub_rate      substitutions per base
  indel_rate    indels per base (half insertions, half deletions)
  foreign_share share of reads (pairs) drawn from random sequence that the
                genome does not hold
  trim          null, or {"keep": p, "min": a, "max": b}: a share 1 - p of the
                reads is cut at its 3' end to a length in [a, b]
  repeat_anchored_share, repeat_kind, repeat_insert
                share of pairs with one mate inside a planted array of that
                kind and the other in its flank, at inserts in repeat_insert

Every count (foreign, trimmed, repeat-anchored reads) is a fixed share of the
pool and every length and insert comes from a fixed set spread over its
range: the seed permutes them and draws where the reads fall, so all seeds
give the card and the host the same amount of work.
"""
from __future__ import annotations

import os

import numpy as np

SLACK = 8           # extra source bases that deletions may pull in
STRANDS = ("OT", "OB", "CTOT", "CTOB")


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream); any whole seed."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), stream]))


def spread(n: int, lo: int, hi: int, rng) -> np.ndarray:
    """n whole numbers evenly covering [lo, hi], in the seed's order."""
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    v = lo + (np.arange(n) * (hi - lo + 1)) // n
    return rng.permutation(v).astype(np.int64)


def fixed_mask(n: int, share: float, rng) -> np.ndarray:
    k = int(round(n * share))
    m = np.zeros(n, dtype=bool)
    m[rng.permutation(n)[:k]] = True
    return m


def revcomp2d(x: np.ndarray) -> np.ndarray:
    return (3 - x[:, ::-1]).astype(np.uint8)


def bisulfite(x: np.ndarray, meth: dict, rng) -> np.ndarray:
    """C -> T unless methylated, in each row's own strand; a C before a G is
    methylated with meth["cpg"], any other C with meth["other"]."""
    out = x.copy()
    c = x == 1
    cpg = np.zeros_like(c)
    cpg[:, :-1] = c[:, :-1] & (x[:, 1:] == 2)
    keep = np.where(cpg, meth["cpg"], meth["other"])
    out[c & (rng.random(x.shape) >= keep)] = 3
    return out


def sequence(src: np.ndarray, n_out: int, sub_rate: float, indel_rate: float,
             rng) -> np.ndarray:
    """Sequencing errors on each row of src (uint8 [n, F], F >= n_out):
    substitutions, then insertions (a random base before the source base)
    and deletions; the first n_out bases of each row are read (a row left
    shorter by deletions is padded with its last source bases)."""
    n, F = src.shape
    x = src.copy()
    subs = rng.random(x.shape) < sub_rate
    x[subs] = (x[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
    if indel_rate <= 0:
        return x[:, :n_out]
    r = rng.random(x.shape)
    counts = np.where(r < indel_rate / 2, 0,
                      np.where(r < indel_rate, 2, 1)).astype(np.int64)
    flat = np.repeat(x.ravel(), counts.ravel())
    first = np.cumsum(counts.ravel()) - counts.ravel()
    ins = counts.ravel() == 2
    flat[first[ins]] = rng.integers(0, 4, int(ins.sum()))
    lens = counts.sum(1)
    starts = np.cumsum(lens) - lens
    take = np.minimum(np.arange(n_out)[None, :], lens[:, None] - 1)
    out = flat[starts[:, None] + take]
    short = lens < n_out
    if short.any():                     # a rare row: its last source bases
        out[short] = src[short][:, F - n_out:]
    return out.astype(np.uint8)


def _fragments(contigs, n: int, width: int, rng):
    """n source fragments of `width` bases from the contigs, uniform over
    positions (a contig drawn by its length): uint8 [n, width]."""
    sizes = np.array([len(c) for c in contigs], dtype=np.int64)
    ci = rng.choice(len(contigs), n, p=sizes / sizes.sum())
    coord = (rng.random(n) * (sizes[ci] - width)).astype(np.int64)
    out = np.empty((n, width), dtype=np.uint8)
    for k, c in enumerate(contigs):
        sel = np.flatnonzero(ci == k)
        out[sel] = np.asarray(c)[coord[sel, None] + np.arange(width)]
    return out


def _foreign(n: int, width: int, rng) -> np.ndarray:
    p = np.array([0.29, 0.21, 0.21, 0.29])
    return rng.choice(4, size=(n, width), p=p).astype(np.uint8)


def _oriented(frag: np.ndarray, strands: np.ndarray, meth, rng):
    """Each row as read from its strand: OT the converted top, OB the
    converted bottom, CTOT / CTOB the reverse complement of those."""
    top = np.isin(strands, (0, 2))
    conv = np.where(top[:, None], frag, revcomp2d(frag))
    conv = bisulfite(conv, meth, rng)
    ct = np.isin(strands, (2, 3))
    return np.where(ct[:, None], revcomp2d(conv), conv)


def se_pool(t: dict, genome, seed: int):
    """Single-end pool: list of uint8 code arrays."""
    rng = rng_for(seed, 1)
    n, m, clip = int(t["pool"]), int(t["read_len"]), int(t.get("clip5", 0))
    width = clip + m + SLACK
    foreign = fixed_mask(n, t.get("foreign_share", 0.0), rng)
    src = _fragments(genome.contigs, n, width, rng)
    src[foreign] = _foreign(int(foreign.sum()), width, rng)
    protos = [STRANDS.index(s) for s in t["protocols"]]
    strands = np.asarray(protos)[rng.integers(0, len(protos), n)]
    oriented = _oriented(src, strands, t["meth"], rng)[:, clip:]
    reads = sequence(oriented, m, t["sub_rate"], t["indel_rate"], rng)
    lens = np.full(n, m, dtype=np.int64)
    trim = t.get("trim")
    if trim:
        cut = ~fixed_mask(n, trim["keep"], rng)
        lens[cut] = spread(int(cut.sum()), trim["min"], trim["max"], rng)
    return [reads[i, :lens[i]] for i in range(n)]


def _anchored_fragments(genome, t: dict, n: int, rng):
    """n FR fragments with one end's read inside a planted array of
    t["repeat_kind"] and the other end's read in its flank."""
    m = int(t["read_len"])
    lo, hi = t["repeat_insert"]
    spans = [(k, s, e) for k, rec in enumerate(genome.records)
             for s, e, kind in rec
             if kind == t["repeat_kind"] and e - s >= m + 1
             and s >= hi and e + hi <= len(genome.contigs[k])]
    if not spans:
        raise ValueError(f"no {t['repeat_kind']} array of {m + 1} bp or more")
    inserts = spread(n, lo, hi, rng)
    pick = rng.integers(0, len(spans), n)
    left_inside = rng.random(n) < 0.5
    frags = np.zeros((n, hi), dtype=np.uint8)
    for i in range(n):
        k, s, e = spans[pick[i]]
        ins = int(inserts[i])
        if left_inside[i]:       # read 1's end in the array, read 2 past it
            a, b = max(s, e - ins + m), e - m
        else:                    # read 2's end in the array, read 1 before
            a, b = s - ins + m, min(s - m, e - ins)
        f = int(rng.integers(a, b + 1))
        frags[i, :ins] = np.asarray(genome.contigs[k][f:f + ins])
    return frags, inserts


def pe_pool(t: dict, genome, seed: int):
    """Paired-end pool: list of (read 1, read 2) code arrays."""
    rng = rng_for(seed, 1)
    n, m = int(t["pool"]), int(t["read_len"])
    lo, hi = t["insert"]
    foreign = fixed_mask(n, t.get("foreign_share", 0.0), rng)
    anchored = fixed_mask(n, t.get("repeat_anchored_share", 0.0), rng) \
        & ~foreign
    inserts = spread(n, lo, hi, rng)
    frags = _fragments(genome.contigs, n, max(hi, m + SLACK), rng)
    frags[foreign] = _foreign(int(foreign.sum()), frags.shape[1], rng)
    if anchored.any():
        fa, ia = _anchored_fragments(genome, t, int(anchored.sum()), rng)
        frags[anchored, :fa.shape[1]] = fa
        inserts[anchored] = ia
    top = rng.random(n) < 0.5
    pairs = []
    for i0 in range(0, n, 8192):
        sl = slice(i0, min(n, i0 + 8192))
        fr, ins, tp = frags[sl], inserts[sl], top[sl]
        w = fr.shape[1]
        # the fragment as its own (converted) strand reads it, left-aligned
        idx = np.arange(w)[None, :]
        rev = np.take_along_axis(3 - fr, np.clip(ins[:, None] - 1 - idx, 0,
                                                 w - 1), 1).astype(np.uint8)
        strand = np.where(tp[:, None], fr, rev)
        conv = bisulfite(strand, t["meth"], rng)
        conv[idx >= ins[:, None]] = 0
        # read 1 from the left, read 2 from the right end's reverse
        # complement; a short insert leaves fewer than read_len + SLACK
        # source bases, and the read is what the insert holds
        r2src = np.take_along_axis(
            3 - conv, np.clip(ins[:, None] - 1 - idx, 0, w - 1),
            1).astype(np.uint8)
        span = np.minimum(ins, m + SLACK)
        r1 = sequence(conv[:, :m + SLACK], m, t["sub_rate"],
                      t["indel_rate"], rng)
        r2 = sequence(r2src[:, :m + SLACK], m, t["sub_rate"],
                      t["indel_rate"], rng)
        for j in range(len(ins)):
            ln = min(m, int(span[j]))
            pairs.append((r1[j, :ln], r2[j, :ln]))
    return pairs


def write_fastq(path: str, reads, names) -> int:
    """Writes reads (code arrays) as FASTQ with names; returns bytes."""
    bases = np.frombuffer(b"ACGTN", dtype=np.uint8)
    quals = {}
    with open(path, "wb") as f:
        total = 0
        parts = []
        for name, r in zip(names, reads):
            q = quals.get(len(r))
            if q is None:
                q = quals[len(r)] = b"I" * len(r)
            parts.append(b"@%s\n%s\n+\n%s\n" % (name.encode(),
                                               bases[r].tobytes(), q))
            if len(parts) >= 65536:
                total += f.write(b"".join(parts))
                parts = []
        total += f.write(b"".join(parts))
    return total


def write_pool(t: dict, pool, tmpdir: str) -> tuple[list[str], list[str]]:
    """The pool's FASTQ file(s) in tmpdir and the read names: one file for
    SE, two (mates 1 and 2, the same names) for PE."""
    if t["mode"] == "se":
        names = [f"r{i}" for i in range(len(pool))]
        path = os.path.join(tmpdir, "reads.fq")
        write_fastq(path, pool, names)
        return [path], names
    names = [f"p{i}" for i in range(len(pool))]
    paths = [os.path.join(tmpdir, f"reads_{k}.fq") for k in (1, 2)]
    for k, path in enumerate(paths):
        write_fastq(path, [p[k] for p in pool], names)
    return paths, names


def make_pool(t: dict, genome, seed: int):
    return (se_pool if t["mode"] == "se" else pe_pool)(t, genome, seed)


def check_sample(t: dict, seed: int) -> np.ndarray:
    """The pool indices whose records a run with this seed checks (those
    among them that its window sends), sorted."""
    n = int(t["pool"])
    rng = rng_for(seed, 2)
    return np.sort(rng.choice(n, min(n, int(t["check_sample"])),
                              replace=False))
