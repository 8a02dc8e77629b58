"""Index construction: FASTA -> packed bisulfite FM-index artifacts.

Reference parity (SURVEY.md C2/C3/C5/C6): FASTA parse + genome packing,
bisulfite text construction, BWT/occ checkpoint building, SA sampling.
The reference builds ONE FM-index over CT(W) ++ CT(rc(W)); we build the same
converted texts as TWO blocks so every device position fits uint32
(SURVEY.md section 7 hard-part 6: a 6.2e9 concatenated text overflows both
int32 and uint32; one strand, ~3.1e9, fits uint32).

Physical layout is defined in bitmapperbs_tpu_torch.constants (CP_BLOCK etc.).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import sys

import numpy as np

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.index import sais
from bitmapperbs_tpu_torch.utils import dna

CONTIG_PAD = 256  # N padding before/between/after contigs; >= any verify window


@dataclasses.dataclass
class Genome:
    """Original (unconverted) genome, concatenated with N padding."""

    names: list[str]
    offsets: np.ndarray   # int64[num_contigs] start of each contig in `codes`
    lengths: np.ndarray   # int64[num_contigs]
    codes: np.ndarray     # uint8[L] in {0..4}, N padding included

    @property
    def length(self) -> int:
        return len(self.codes)

    def pos_to_contig(self, pos: int) -> tuple[int, int]:
        """Forward-genome position -> (contig_idx, 0-based coord)."""
        i = int(np.searchsorted(self.offsets, pos, side="right")) - 1
        return i, pos - int(self.offsets[i])

    def rc_codes(self) -> np.ndarray:
        """Reverse-complement codes, computed once and cached (contiguous).

        The host finalize paths need rc(W) on every batch; recomputing it
        per map_batch_* call costs 27 ms at 10 Mbp and ~9 s at 3 Gbp
        (PERF.md round-4 e2e stage study)."""
        rc = getattr(self, "_rc_codes", None)
        if rc is None:
            rc = np.ascontiguousarray(dna.revcomp(self.codes))
            self._rc_codes = rc
        return rc

    def packed_planes(self) -> dict[str, np.ndarray]:
        """Bit-packed planes of the original genome, both orientations.

        Returns g0/g1 (code bit planes, LSB = lowest position) and gn (N mask)
        for the forward genome, and r0/r1/rn for rc(W).  Block-1 verification
        reads rc(W) directly instead of bit-reversing forward words in-kernel.
        """
        out = {}
        for pref, codes in (("g", self.codes), ("r", dna.revcomp(self.codes))):
            isn = codes == K.N_CODE
            c = np.where(isn, 0, codes).astype(np.uint8)
            out[pref + "0"] = _pack_bits(c & 1)
            out[pref + "1"] = _pack_bits((c >> 1) & 1)
            out[pref + "n"] = _pack_bits(isn.astype(np.uint8))
        return out


def parse_fasta(path_or_text) -> Genome:
    """Multi-contig FASTA -> Genome with CONTIG_PAD Ns around each contig.

    A Genome passes through unchanged, so build_index() also accepts
    direct-codes genomes (utils/simulate.random_genome) without a GB-scale
    FASTA round trip."""
    if isinstance(path_or_text, Genome):
        return path_or_text
    if isinstance(path_or_text, (str, os.PathLike)) and os.path.exists(path_or_text):
        import gzip

        opener = gzip.open if str(path_or_text).endswith(".gz") else open
        with opener(path_or_text, "rt") as f:
            text = f.read()
    else:
        text = path_or_text
    names, seqs, cur = [], [], None
    for line in io.StringIO(text):
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            names.append(line[1:].split()[0])
            cur = []
            seqs.append(cur)
        else:
            if cur is None:
                raise ValueError("FASTA sequence line before any '>' header")
            cur.append(line)
    if not names:
        raise ValueError("no contigs in FASTA")
    pad = np.full(CONTIG_PAD, K.N_CODE, dtype=np.uint8)
    pieces, offsets, lengths = [pad], [], []
    pos = CONTIG_PAD
    for s in seqs:
        codes = dna.encode("".join(s))
        offsets.append(pos)
        lengths.append(len(codes))
        pieces.append(codes)
        pieces.append(pad)
        pos += len(codes) + CONTIG_PAD
    return Genome(
        names=names,
        offsets=np.asarray(offsets, dtype=np.int64),
        lengths=np.asarray(lengths, dtype=np.int64),
        codes=np.concatenate(pieces),
    )


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """uint8[0/1] array -> uint32 words, LSB = lowest position."""
    n = len(bits)
    npad = -n % 32
    if npad:
        bits = np.concatenate([bits, np.zeros(npad, dtype=np.uint8)])
    return np.packbits(bits, bitorder="little").view("<u4").copy()


@dataclasses.dataclass
class PackedBlock:
    """One FM-index block (SURVEY.md C5-C8 artifacts) over a converted text.

    cp_rows carries BWT planes, occ checkpoints AND SA-sample mark bits in
    one row (constants.py layout) so the device LF step is a single gather.
    """

    n: int                    # text length including the trailing sentinel
    cbase: np.ndarray         # uint32[4]: C[c] = # symbols with code < c
    cp_rows: np.ndarray       # uint32[R, CP_ROW_U32]
    sa_samples: np.ndarray    # uint32[num_marks] SA values at marked rows
    sa_rate: int = K.DEFAULT_SA_RATE   # SA sampling rate (locate walk bound)
    klt_k: int = 0            # k-mer lookup-table depth (0 = no table)
    klt: np.ndarray | None = None      # uint32[3^klt_k, 2] (sp, ep)

    def nbytes(self) -> int:
        return (self.cbase.nbytes + self.cp_rows.nbytes
                + self.sa_samples.nbytes
                + (self.klt.nbytes if self.klt is not None else 0))


def build_klt(block: "PackedBlock", k: int) -> np.ndarray:
    """k-mer lookup table: uint32[3^k, 2] of (sp, ep) after k backward steps.

    Index convention matches ops/fm.rolling_kmers: the character consumed at
    backward step t (pattern position end-1-t, converted code c in {1,2,3})
    contributes (c-1) * 3^t.  Entries carry the SAME freeze-on-empty
    semantics as the search loops (host packed.count and device
    fm.search_patterns): once an interval empties, further extensions keep
    the first-empty (sp, ep) values -- so table-initialized search is
    bit-identical to the plain loop, not just emptiness-equivalent.
    """
    from bitmapperbs_tpu_torch.index import packed  # local: avoid import cycle

    sp = np.zeros(1, dtype=np.uint64)
    ep = np.array([block.n], dtype=np.uint64)
    for t in range(k):
        sz = 3 ** t
        empty = sp >= ep
        nsp = np.empty(3 * sz, dtype=np.uint64)
        nep = np.empty(3 * sz, dtype=np.uint64)
        for c in (K.CONV_A, K.CONV_G, K.CONV_T):
            cc = np.full(sz, c, dtype=np.uint32)
            s2, e2 = packed.extend_backward(block, sp, ep, cc)
            lo = (c - 1) * sz
            nsp[lo:lo + sz] = np.where(empty, sp, s2)
            nep[lo:lo + sz] = np.where(empty, ep, e2)
        sp, ep = nsp, nep
    return np.stack([sp, ep], axis=1).astype(np.uint32)


def _mem_available_bytes() -> int | None:
    """Linux MemAvailable in bytes; None when undeterminable (callers
    should then choose the bounded-RAM path)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def default_klt_k(n: int) -> int:
    """Table depth: no deeper than log3(n) (beyond that nearly all entries
    are empty and the table is wasted memory), capped at KLT_MAX_K -- or
    KLT_MAX_K_GBP for Gbp-scale texts (the reference's choice, see
    constants.py)."""
    cap = (K.KLT_MAX_K_GBP if n > K.KLT_GBP_THRESHOLD else K.KLT_MAX_K)
    k = 0
    while 3 ** (k + 1) <= n and k < cap:
        k += 1
    return k


def _pack_cp_from_packed_bwt(n: int, packed_bwt: np.ndarray,
                             mark_bits: np.ndarray,
                             chunk_rows: int = 1 << 18):
    """Checkpoint rows from a 2-bit-packed BWT + SA-mark bitset, streamed.

    The low-memory build path (bwt_via_insertion) never materializes the
    BWT as one byte per char; this packer works in bounded chunks so peak
    transient memory stays ~chunk-sized regardless of n.  Output is
    byte-identical to the SA-IS path's packing.
    """
    rows = -(-n // K.CP_BLOCK)
    cp = np.zeros((rows, K.CP_ROW_U32), dtype=np.uint32)
    run = np.zeros(K.CONV_ALPHA, dtype=np.uint64)
    mark_run = np.uint64(0)
    bytes_per_row = K.CP_BLOCK // 4          # 2-bit codes
    mark_bytes_per_row = K.CP_BLOCK // 8
    mb_pad = np.zeros(rows * mark_bytes_per_row, dtype=np.uint8)
    mb_pad[:len(mark_bits)] = mark_bits
    for r0 in range(0, rows, chunk_rows):
        r1 = min(r0 + chunk_rows, rows)
        nr = r1 - r0
        chunk = np.zeros(nr * bytes_per_row, dtype=np.uint8)
        src = packed_bwt[r0 * bytes_per_row:r1 * bytes_per_row]
        chunk[:len(src)] = src
        codes = ((chunk[:, None] >> np.arange(0, 8, 2, dtype=np.uint8))
                 & 3).reshape(nr, K.CP_BLOCK).astype(np.uint8)
        for c in range(K.CONV_ALPHA):
            per_row = (codes == c).sum(axis=1, dtype=np.uint64)
            cum = np.cumsum(per_row)
            cp[r0:r1, c] = (run[c] + cum - per_row).astype(np.uint32)
            run[c] += cum[-1]
        flat = codes.reshape(-1)
        cp[r0:r1, K.CONV_ALPHA:K.CONV_ALPHA + K.CP_WORDS] = _pack_bits(
            (flat & 1).astype(np.uint8)).reshape(nr, K.CP_WORDS)
        cp[r0:r1, K.CONV_ALPHA + K.CP_WORDS:K.CP_MARK_OFF] = _pack_bits(
            ((flat >> 1) & 1).astype(np.uint8)).reshape(nr, K.CP_WORDS)
        mw = mb_pad[r0 * mark_bytes_per_row:r1 * mark_bytes_per_row].view(
            "<u4").reshape(nr, K.CP_WORDS)
        cp[r0:r1, K.CP_MARK_OFF + 1:] = mw
        mrow = np.bitwise_count(mw).sum(axis=1, dtype=np.uint64)
        mcum = np.cumsum(mrow)
        cp[r0:r1, K.CP_MARK_OFF] = (mark_run + mcum - mrow).astype(np.uint32)
        mark_run += mcum[-1]
    run[0] -= np.uint64(rows * K.CP_BLOCK - n)   # zero-pad is not sentinel
    cbase = np.zeros(K.CONV_ALPHA, dtype=np.uint32)
    cbase[1:] = np.cumsum(run)[:-1].astype(np.uint32)
    return cp, cbase


def build_block(conv_text: np.ndarray, sa: np.ndarray | None = None,
                sa_rate: int = K.DEFAULT_SA_RATE,
                klt_k: int | None = None,
                mode: str = "sais") -> PackedBlock:
    """Converted text (codes 1..3, no sentinel) -> PackedBlock.

    Reference parity: C5 (BWT + occ checkpoints) and C6 (SA sampling).
    mode="lowmem" builds the BWT by native dynamic insertion without ever
    materializing a suffix array (the pSAscan role, SURVEY.md C4); artifacts
    are byte-identical to the SA-IS path.
    """
    if mode == "lowmem" and sa is None:
        from bitmapperbs_tpu_torch.index import sais as _sais
        text = np.concatenate([
            np.ascontiguousarray(conv_text, dtype=np.uint8),
            np.zeros(1, dtype=np.uint8)])
        n = len(text)
        if n - 1 >= 2**32 - 1:
            raise ValueError("block text exceeds uint32 positions")
        packed, marks, samples = _sais.bwt_via_insertion(text, sa_rate)
        cp, cbase = _pack_cp_from_packed_bwt(n, packed, marks)
        block = PackedBlock(n=n, cbase=cbase, cp_rows=cp,
                            sa_samples=samples.astype(np.uint32),
                            sa_rate=sa_rate)
        block.klt_k = default_klt_k(n) if klt_k is None else klt_k
        block.klt = build_klt(block, block.klt_k)
        return block
    text = np.concatenate([
        np.ascontiguousarray(conv_text, dtype=np.uint8),
        np.zeros(1, dtype=np.uint8),   # sentinel
    ])
    n = len(text)
    if n - 1 >= 2**32 - 1:
        raise ValueError("block text exceeds uint32 positions")
    if sa is None:
        sa = sais.suffix_array(text)
    bwt = text[(sa - 1) % n]

    # cumulative alphabet counts C[c]
    hist = np.bincount(text, minlength=K.CONV_ALPHA).astype(np.uint64)
    cbase = np.zeros(K.CONV_ALPHA, dtype=np.uint32)
    cbase[1:] = np.cumsum(hist)[:-1].astype(np.uint32)

    rows = -(-n // K.CP_BLOCK)
    npad = rows * K.CP_BLOCK - n
    bwt_pad = np.concatenate([bwt, np.zeros(npad, dtype=np.uint8)])

    cp = np.zeros((rows, K.CP_ROW_U32), dtype=np.uint32)
    per_row = bwt_pad.reshape(rows, K.CP_BLOCK)
    for c in range(K.CONV_ALPHA):
        ind = per_row == c
        # count of c strictly before each row (padding is past every valid i)
        cnt = np.zeros(rows, dtype=np.uint64)
        cnt[1:] = np.cumsum(ind.sum(axis=1, dtype=np.uint64))[:-1]
        if c == 0:  # padding bytes are 0s; remove them from nothing (pad at end)
            pass
        cp[:, c] = cnt.astype(np.uint32)
    p0 = _pack_bits((bwt_pad & 1).astype(np.uint8)).reshape(rows, K.CP_WORDS)
    p1 = _pack_bits(((bwt_pad >> 1) & 1).astype(np.uint8)).reshape(rows, K.CP_WORDS)
    cp[:, K.CONV_ALPHA:K.CONV_ALPHA + K.CP_WORDS] = p0
    cp[:, K.CONV_ALPHA + K.CP_WORDS:K.CP_MARK_OFF] = p1

    # SA sampling, text-order: mark rows whose SA value % rate == 0
    marked = (sa % sa_rate) == 0
    marked_pad = np.concatenate([marked, np.zeros(npad, dtype=bool)])
    cnt = np.zeros(rows, dtype=np.uint64)
    cnt[1:] = np.cumsum(marked_pad.reshape(rows, K.CP_BLOCK).sum(axis=1, dtype=np.uint64))[:-1]
    cp[:, K.CP_MARK_OFF] = cnt.astype(np.uint32)
    cp[:, K.CP_MARK_OFF + 1:] = _pack_bits(
        marked_pad.astype(np.uint8)).reshape(rows, K.CP_WORDS)
    sa_samples = sa[marked].astype(np.uint32)

    block = PackedBlock(n=n, cbase=cbase, cp_rows=cp, sa_samples=sa_samples,
                        sa_rate=sa_rate)
    block.klt_k = default_klt_k(n) if klt_k is None else klt_k
    block.klt = build_klt(block, block.klt_k)
    return block


@dataclasses.dataclass
class BSIndex:
    """Full bisulfite index: original genome + two converted FM blocks."""

    genome: Genome
    blocks: list[PackedBlock]   # [BLOCK_FWD over CT(W), BLOCK_RC over CT(rc(W))]
    meta: dict
    # artifact prefix when mmap-loaded from disk (None for in-RAM builds);
    # lets upload_index find/create the derived genome-plane cache next to
    # the artifact instead of recomputing packed_planes (minutes at Gbp)
    source_prefix: str | None = None

    def nbytes(self) -> int:
        return sum(b.nbytes() for b in self.blocks) + self.genome.codes.nbytes


INDEX_VERSION = 4   # v4: raw .bin segments (mmap-loadable); v3 .npz legacy


def _build_block_worker(text_path, n_text, sa_rate, klt_k, mode, out_dir):
    """Spawned worker: build one FM block from a memmapped converted text
    and serialize it for the parent (numpy-only children)."""
    conv = np.memmap(text_path, dtype=np.uint8, mode="r", shape=(n_text,))
    blk = build_block(conv, sa_rate=sa_rate, klt_k=klt_k, mode=mode)
    np.save(os.path.join(out_dir, "cbase.npy"), blk.cbase)
    np.save(os.path.join(out_dir, "cp_rows.npy"), blk.cp_rows)
    np.save(os.path.join(out_dir, "sa_samples.npy"), blk.sa_samples)
    if blk.klt is not None:
        np.save(os.path.join(out_dir, "klt.npy"), blk.klt)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"n": blk.n, "sa_rate": blk.sa_rate,
                   "klt_k": blk.klt_k}, f)


def _build_blocks_parallel(ct_fwd, ct_rc, sa_rate, klt_k, mode):
    """Build the CT(W) and CT(rc W) blocks in two spawned processes.

    The blocks are fully independent (SURVEY.md 3.1), so a >=2-core host
    halves the dominant suffix-array wall time (a 3.08 Gbp single-core
    SA-IS build measures ~9 h; the two block builds are ~all of it).
    Artifacts are byte-identical to the sequential path
    (tests/test_fm_index.py::test_parallel_block_build).  RAM peak is two
    concurrent builds (~12 B/char each for sais; ~1 B/char for lowmem).
    Workers talk through temp files: fresh interpreters (fork is unsafe
    under a device runtime's threads) + pickling multi-GB arrays through pipes is slower
    than tofile.  Children run under subprocess with a per-child env (the
    parent's environ is never mutated, so concurrent spawns elsewhere can't
    race on PYTHONPATH) and their stderr is captured into the RuntimeError.
    """
    import shutil
    import subprocess
    import tempfile

    d = tempfile.mkdtemp(prefix="btbs_build_")
    try:
        jobs = []
        for name, text in (("fwd", ct_fwd), ("rc", ct_rc)):
            tp = os.path.join(d, f"{name}.u8")
            np.ascontiguousarray(text, dtype=np.uint8).tofile(tp)
            od = os.path.join(d, name)
            os.makedirs(od)
            jobs.append((tp, len(text), sa_rate, klt_k, mode, od))
        # numpy-only children; keep the package importable
        env = dict(os.environ)
        parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        if pkg_root not in parts:
            parts.insert(0, pkg_root)
        env["PYTHONPATH"] = os.pathsep.join(parts)
        runner = ("import json,sys\n"
                  "from bitmapperbs_tpu_torch.index.build import "
                  "_build_block_worker\n"
                  "_build_block_worker(*json.load(open(sys.argv[1])))\n")
        procs = []
        for j in jobs:
            argf = os.path.join(j[-1], "args.json")
            with open(argf, "w") as f:
                json.dump(list(j), f)
            errf = open(os.path.join(j[-1], "err.txt"), "wb")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", runner, argf], env=env,
                stderr=errf), errf, j[-1]))
        fails = []
        for p, errf, od in procs:
            rc = p.wait()
            errf.close()
            if rc != 0:
                with open(os.path.join(od, "err.txt"),
                          errors="replace") as f:
                    tail = f.read()[-2000:]
                fails.append(f"worker {os.path.basename(od)} exit {rc}:"
                             f"\n{tail}")
        if fails:
            raise RuntimeError("parallel block build failed\n"
                               + "\n".join(fails))
        blocks = []
        for _, _, _, _, _, od in jobs:
            with open(os.path.join(od, "meta.json")) as f:
                meta = json.load(f)
            klt_path = os.path.join(od, "klt.npy")
            blocks.append(PackedBlock(
                n=meta["n"],
                cbase=np.load(os.path.join(od, "cbase.npy")),
                cp_rows=np.load(os.path.join(od, "cp_rows.npy")),
                sa_samples=np.load(os.path.join(od, "sa_samples.npy")),
                sa_rate=meta["sa_rate"],
                klt_k=meta["klt_k"],
                klt=np.load(klt_path) if os.path.exists(klt_path) else None,
            ))
        return blocks
    finally:
        shutil.rmtree(d, ignore_errors=True)


def build_index(fasta, sa_rate: int | None = None,
                klt_k: int | None = None,
                build_mode: str = "auto", jobs: int = 1) -> BSIndex:
    """FASTA -> BSIndex (SURVEY.md call stack 3.1).

    sa_rate default is 4 up to 3.5 Gbp, DEFAULT_SA_RATE (8) above: the
    reference package's rule, kept so both packages build the same
    artifact from the same FASTA.  It was sized for the reference's 16 GB
    TPU (rate 4 halves the locate LF walk, +23% reads/s there at 3.08 Gbp,
    12.6 GB artifact, ~4.1 GB/Gbp); on a larger card `resample` can densify
    a rate-8 artifact later.

    build_mode: "sais" (in-RAM suffix array, ~29 B/char peak measured at
    1.03 Gbp, fastest), "lowmem" (native dynamic-BWT insertion, ~11 B/char
    peak, no SA ever -- the pSAscan role for whole-genome builds on small
    hosts; byte-identical artifacts, 4.2x the CPU), or "auto" (RAM-aware
    for texts over 512 Mbp: sais when MemAvailable fits its measured peak
    with 25% headroom, else lowmem).
    """
    genome = parse_fasta(fasta)
    if sa_rate is None:
        sa_rate = 4 if len(genome.codes) <= 3_500_000_000 \
            else K.DEFAULT_SA_RATE
    mode = build_mode
    if mode == "auto":
        from bitmapperbs_tpu_torch.index import sais as _sais
        lib = _sais._native_lib()
        big = len(genome.codes) > (1 << 29)
        if big and lib is not None and hasattr(lib, "bwtinc_build"):
            # RAM-aware (round 5, measured at 1.03 Gbp): in-RAM SA-IS is
            # 4.2x faster (1487s vs 6211s CPU) but peaks at ~29 B/char
            # (29.7 GB) vs lowmem's ~11 B/char (11.45 GB); artifacts are
            # byte-identical (scripts/lowmem_bench.py).  Prefer sais
            # whenever the host comfortably fits it; lowmem is the
            # bounded-RAM fallback (the pSAscan role, SURVEY.md C4).
            avail = _mem_available_bytes()
            need = int(29 * 1.25 * (len(genome.codes) + 1))
            mode = ("sais" if avail is not None and avail > need
                    else "lowmem")
        else:
            mode = "sais"
    ct_fwd = dna.ct_convert(genome.codes)
    ct_rc = dna.ct_convert(dna.revcomp(genome.codes))
    if klt_k is None:
        klt_k = default_klt_k(len(genome.codes) + 1)
    if jobs >= 2:
        blocks = _build_blocks_parallel(ct_fwd, ct_rc, sa_rate, klt_k, mode)
    else:
        blocks = [build_block(ct_fwd, sa_rate=sa_rate, klt_k=klt_k,
                              mode=mode),
                  build_block(ct_rc, sa_rate=sa_rate, klt_k=klt_k,
                              mode=mode)]
    meta = {
        "version": INDEX_VERSION,
        "genome_sha256": hashlib.sha256(genome.codes.tobytes()).hexdigest(),
        "cp_block": K.CP_BLOCK,
        "sa_sample_rate": sa_rate,
        "klt_k": klt_k,
        "contig_pad": CONTIG_PAD,
    }
    return BSIndex(genome=genome, blocks=blocks, meta=meta)


def _index_arrays(idx: BSIndex) -> dict[str, np.ndarray]:
    arrays = {
        "genome_codes": idx.genome.codes,
        "genome_offsets": idx.genome.offsets,
        "genome_lengths": idx.genome.lengths,
    }
    for bi, b in enumerate(idx.blocks):
        arrays[f"b{bi}_cbase"] = b.cbase
        arrays[f"b{bi}_cp_rows"] = b.cp_rows
        arrays[f"b{bi}_sa_samples"] = b.sa_samples
        arrays[f"b{bi}_klt"] = b.klt
    return arrays


def save_index(idx: BSIndex, prefix: str) -> None:
    """Serialize as <prefix>.bin (raw aligned arrays) + <prefix>.json.

    One flat binary with 64-byte-aligned array segments, described by the
    manifest: loads are a single mmap (np.load on multi-GB .npz measured
    ~16 MB/s on this format's predecessor vs ~1.4 GB/s raw -- a 9.5 GB
    human-scale artifact went from ~10 min to instant).  SURVEY.md C6.
    """
    arrays = _index_arrays(idx)
    segs = {}
    off = 0
    with open(prefix + ".bin", "wb") as f:
        for name, a in arrays.items():
            a = np.ascontiguousarray(a)
            pad = -off % 64
            f.write(b"\0" * pad)
            off += pad
            segs[name] = {"dtype": a.dtype.str, "shape": list(a.shape),
                          "offset": off}
            a.tofile(f)   # streams; tobytes() would copy multi-GB arrays
            off += a.nbytes
    manifest = dict(idx.meta)
    manifest["names"] = idx.genome.names
    manifest["block_n"] = [b.n for b in idx.blocks]
    manifest["segments"] = segs
    with open(prefix + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


LEGACY_NPZ_VERSION = 3   # round-1/2 .npz artifacts stay loadable


def load_index(prefix: str, mmap: bool = True) -> BSIndex:
    """Load an index artifact; v4 .bin segments are mmap-backed views
    (read-only) unless mmap=False copies them into RAM."""
    with open(prefix + ".json") as f:
        manifest = json.load(f)
    ver = manifest["version"]
    if ver == INDEX_VERSION:
        raw = np.memmap(prefix + ".bin", dtype=np.uint8, mode="r")
        try:
            # async sequential readahead (page cache is per-inode, so a
            # separate fd works): simulate/finalize/upload touch the mmap
            # in random order, and cold demand-paging a 12.6 GB artifact
            # one 4K fault at a time measured 30s-30min (round 5, depending
            # on page-cache state); the WILLNEED hint streams it in at
            # disk-sequential speed without blocking this call
            fd = os.open(prefix + ".bin", os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_WILLNEED)
            finally:
                os.close(fd)
        except (AttributeError, OSError):
            pass
        z = {}
        for name, seg in manifest["segments"].items():
            dt = np.dtype(seg["dtype"])
            n = int(np.prod(seg["shape"], dtype=np.int64)) * dt.itemsize
            o = seg["offset"]
            z[name] = raw[o:o + n].view(dt).reshape(seg["shape"])
            if not mmap:
                z[name] = np.array(z[name])
    elif ver == LEGACY_NPZ_VERSION:
        z = np.load(prefix + ".npz")
    else:
        raise ValueError(f"index version {ver} != {INDEX_VERSION}")
    genome = Genome(
        names=manifest["names"],
        offsets=z["genome_offsets"],
        lengths=z["genome_lengths"],
        codes=z["genome_codes"],
    )
    blocks = []
    for bi in range(2):
        blocks.append(PackedBlock(
            n=manifest["block_n"][bi],
            cbase=z[f"b{bi}_cbase"],
            cp_rows=z[f"b{bi}_cp_rows"],
            sa_samples=z[f"b{bi}_sa_samples"],
            sa_rate=manifest["sa_sample_rate"],
            klt_k=manifest["klt_k"],
            klt=z[f"b{bi}_klt"],
        ))
    meta = {k: manifest[k] for k in
            ("version", "genome_sha256", "cp_block", "sa_sample_rate",
             "klt_k", "contig_pad")}
    meta["version"] = INDEX_VERSION
    return BSIndex(genome=genome, blocks=blocks, meta=meta,
                   source_prefix=str(prefix))
