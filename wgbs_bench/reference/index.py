"""The reference's seed search: no index at all, a scan of the genome.

Each block is the converted text of one strand (block 0: CT(W), block 1:
CT(rc W), N as A, as the spec converts it).  The seeds of every read to be
mapped are counted in one pass over each block (`locate`), on four threads
over stretches of the text: the 16 characters from each position are packed
into a number, a table of the patterns' first characters picks the
positions worth a look, and those are compared whole.  A pattern's
positions are kept where it has at most `cap` of them, more than the spec
ever reads (a pattern longer than 16 characters: always).  A seed that the
spec grows to the left is counted from its shorter form's positions, or,
where those were too many to keep, in one more pass.  The spec's only
dependence on suffix order, which entries the locate budget keeps, is served
by sorting one seed's occurrences by the text after them.  Nothing is
written to disk; the pass costs about the same at any number of reads.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from wgbs_bench.reference import constants as K
from wgbs_bench.reference import dna

KMER = 16           # characters packed per position (2 bits each)
CHUNK = 1 << 24     # positions per step of the scan
THREADS = 4         # steps at a time
PICK = 11           # characters that index the table of worthwhile positions
CONTIG_PAD = 256      # N before, between and after the contigs (the format's)


class Genome:
    """The padded forward genome, as the SAM coordinates count it."""

    def __init__(self, names, contigs):
        pad = np.full(CONTIG_PAD, K.N_CODE, dtype=np.uint8)
        pieces, offsets, lengths, pos = [pad], [], [], CONTIG_PAD
        for c in contigs:
            offsets.append(pos)
            lengths.append(len(c))
            pieces += [np.asarray(c, dtype=np.uint8), pad]
            pos += len(c) + CONTIG_PAD
        self.names = list(names)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.codes = np.concatenate(pieces)
        self._rc = None

    @property
    def length(self) -> int:
        return len(self.codes)

    def pos_to_contig(self, pos: int) -> tuple[int, int]:
        i = int(np.searchsorted(self.offsets, pos, side="right")) - 1
        return i, pos - int(self.offsets[i])

    def rc_codes(self) -> np.ndarray:
        if self._rc is None:
            self._rc = np.ascontiguousarray(dna.revcomp(self.codes))
        return self._rc


def codes16(conv: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """uint32 [hi - lo]: the KMER characters from each position in [lo, hi),
    2 bits each, the first highest, 0 past the text's end."""
    n, k = len(conv), hi - lo
    seg = np.zeros(k + KMER - 1, dtype=np.uint32)
    t = min(hi + KMER - 1, n)
    seg[:t - lo] = conv[lo:t]
    c4 = (seg[:k + 12] << 6) | (seg[1:k + 13] << 4) | (seg[2:k + 14] << 2) \
        | seg[3:k + 15]
    return (c4[:k] << 24) | (c4[4:k + 4] << 16) | (c4[8:k + 8] << 8) \
        | c4[12:k + 12]


def prefix_code(pat: np.ndarray) -> int:
    code = 0
    for c in pat[:KMER]:
        code = (code << 2) | int(c)
    return code


def scan(conv: np.ndarray, pats: list[np.ndarray], cap: int):
    """Every pattern's count in the text (converted codes 1-3) and its
    positions, sorted, where it has at most `cap` of them (a pattern of
    more than KMER characters: always): ({bytes: count}, {bytes: uint32})."""
    n = len(conv)
    by_len: dict = {}
    for p in pats:
        by_len.setdefault(min(len(p), KMER), set()).add(prefix_code(p))
    want = {k: np.array(sorted(c), dtype=np.uint32)
            for k, c in by_len.items()}
    # a position is worth a look if its first PICK characters (or all of a
    # shorter pattern's) begin some pattern
    pick = np.zeros(1 << (2 * PICK), dtype=bool)
    for k, codes in want.items():
        if k >= PICK:
            pick[codes >> np.uint32(2 * (k - PICK))] = True
        else:
            span = 1 << (2 * (PICK - k))
            for c in codes:
                pick[int(c) * span:(int(c) + 1) * span] = True
    # per class: a table from key to pattern (short keys), or of the first
    # PICK characters of its keys (long ones)
    table = {}
    for k, w in want.items():
        if k <= PICK:
            table[k] = np.full(1 << (2 * k), -1, dtype=np.int64)
            table[k][w] = np.arange(len(w))
        else:
            table[k] = np.zeros(1 << (2 * PICK), dtype=bool)
            table[k][w >> np.uint32(2 * (k - PICK))] = True
    first = np.uint32(2 * (KMER - PICK))

    def step(lo):
        """One stretch of the text: per class, the patterns matched there
        (those past the cap in this stretch left out) and their positions,
        and the counts."""
        code = codes16(conv, lo, min(lo + CHUNK, n))
        cand = np.flatnonzero(pick[code >> first])
        code = code[cand]
        out = {}
        for k, w in want.items():
            key = code >> np.uint32(2 * (KMER - k))
            if k <= PICK:
                at = table[k][key]
                ok = at >= 0
                at, pos = at[ok], cand[ok] + lo
            else:
                sub = np.flatnonzero(table[k][code >> first])
                key = key[sub]
                at = np.minimum(np.searchsorted(w, key), len(w) - 1)
                ok = w[at] == key
                at, pos = at[ok], cand[sub[ok]] + lo
            cnt = np.bincount(at, minlength=len(w))
            if k < KMER:
                light = cnt[at] <= cap
                at, pos = at[light], pos[light]
            out[k] = (cnt, at, pos.astype(np.int64))
        return out

    counts = {k: np.zeros(len(w), dtype=np.int64) for k, w in want.items()}
    kept = {k: ([], []) for k in want}
    with ThreadPoolExecutor(THREADS) as ex:     # numpy lets go of the GIL
        for out in ex.map(step, range(0, n, CHUNK)):
            for k, (cnt, at, pos) in out.items():
                counts[k] += cnt
                kept[k][0].append(at)
                kept[k][1].append(pos)
    found = {}
    for k, (at, pos) in kept.items():
        at, pos = np.concatenate(at), np.concatenate(pos)
        order = np.argsort(at, kind="stable")
        found[k] = (at[order], pos[order])
    count, where = {}, {}
    for k, group in by_len.items():
        at, pos = found[k]
        pk = [p for p in pats if min(len(p), KMER) == k]
        i = np.searchsorted(want[k], np.array([prefix_code(p) for p in pk],
                                              dtype=np.uint32))
        lo, hi = np.searchsorted(at, i, "left"), np.searchsorted(at, i, "right")
        for p, ii, a, b in zip(pk, i.tolist(), lo.tolist(), hi.tolist()):
            key = p.tobytes()
            count[key] = int(counts[k][ii])
            if len(p) <= KMER and count[key] > cap:
                continue
            hit = pos[a:b]
            hit = hit[hit + len(p) <= n]
            for j in range(KMER, len(p)):
                hit = hit[conv[hit + j] == p[j]]
            count[key] = len(hit)
            where[key] = np.sort(hit).astype(np.uint32)
    return count, where


class Block:
    """One strand's converted text and the seeds found in it."""

    def __init__(self, conv: np.ndarray, cap: int = 1 << 10):
        self.conv = conv
        self.n = len(conv) + 1          # with the sentinel, as the spec's n
        self.cap = cap                  # positions kept of a short pattern
        self.counts: dict = {}
        self.where: dict = {}
        self._text = None

    def locate(self, pats) -> None:
        """Counts, in one pass, every pattern not counted yet."""
        new = {np.asarray(p, dtype=np.uint8).tobytes(): np.asarray(
            p, dtype=np.uint8) for p in pats}
        new = [p for b, p in new.items() if b not in self.counts and len(p)]
        if new:
            count, where = scan(self.conv, new, self.cap)
            self.counts.update(count)
            self.where.update(where)

    def count(self, pat: np.ndarray) -> int:
        """How often the converted pattern occurs in the text: counted by
        the scan, or, where the pattern less its first character has its
        positions kept, those that the text extends by that character."""
        pat = np.asarray(pat, dtype=np.uint8)
        key = pat.tobytes()
        if key not in self.counts:
            tail = self.where.get(pat[1:].tobytes())
            if tail is None:
                self.locate([pat])
            else:
                occ = tail.astype(np.int64)
                occ = occ[occ >= 1]
                occ = occ[self.conv[occ - 1] == pat[0]] - 1
                self.counts[key] = len(occ)
                self.where[key] = occ.astype(np.uint32)
        return self.counts[key]

    def find(self, pat: np.ndarray) -> np.ndarray:
        """Text positions where the converted pattern occurs; a pattern of
        at most KMER characters and more than `cap` places has none kept."""
        pat = np.asarray(pat, dtype=np.uint8)
        self.locate([pat])
        if pat.tobytes() not in self.where:
            raise ValueError(f"{self.counts[pat.tobytes()]} places: over "
                             f"the cap of {self.cap}")
        return self.where[pat.tobytes()]

    def suffix_sorted(self, pos: np.ndarray) -> np.ndarray:
        """The positions in the order of the suffixes that start there."""
        if self._text is None:
            self._text = self.conv.tobytes()
        pos = [int(p) for p in pos]
        w = 64
        while True:
            keys = [self._text[p:p + w] for p in pos]
            if len(set(keys)) == len(keys):
                break
            w *= 2
        return np.asarray([p for _, p in sorted(zip(keys, pos))],
                          dtype=np.uint32)


class Index:
    """The genome and its two blocks, as the spec's functions read them."""

    def __init__(self, genome: Genome):
        self.genome = genome
        self.blocks = [Block(np.ascontiguousarray(dna.ct_convert(codes)))
                       for codes in (genome.codes, genome.rc_codes())]
