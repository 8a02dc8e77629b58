"""FASTQ reading and batching (SURVEY.md C17).

Streaming reader for FASTQ / FASTQ.gz (zlib -- the same native codec the
reference links), yielding fixed-size batches for the device pipeline.
The reader tracks a byte-offset cursor for checkpoint/resume (SURVEY.md
section 5.3/5.4: batch-granular resume of a streaming run).
"""
from __future__ import annotations

import dataclasses
import gzip
import io
import os

import numpy as np

from bitmapperbs_tpu_torch.utils import dna
from bitmapperbs_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class ReadBatch:
    qnames: list[str]
    codes: list[np.ndarray]
    quals: list[str]
    start_record: int          # index of first read in this batch
    end_offset: int            # uncompressed byte offset after this batch

    def __len__(self):
        return len(self.qnames)


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


_WS = np.zeros(256, dtype=bool)
_WS[[9, 10, 11, 12, 13, 32]] = True     # str.split() / strip() whitespace


class FastqReader:
    """Iterates ReadBatches; resumable from (record_index, byte_offset).

    limit_offset / limit_records bound the reader to a shard of the file
    (multi-host byte-range input sharding, parallel/multihost.py): the
    reader stops before any record starting at/after limit_offset, or after
    yielding limit_records records, whichever comes first."""

    _CHUNK = 8 << 20

    def __init__(self, path, batch_size: int = 4096, phred64: bool = False,
                 resume_offset: int = 0, resume_record: int = 0,
                 limit_offset: int | None = None,
                 limit_records: int | None = None):
        self.path = path
        self.batch_size = batch_size
        self.phred64 = phred64
        self.limit_offset = limit_offset
        self.limit_records = limit_records
        self._fh = _open(path)
        if resume_offset:
            self._fh.seek(resume_offset)
        self._record = resume_record       # index of next record to yield
        self._offset = resume_offset       # offset after last yielded record
        self._yielded = 0
        # Chunk-vectorized parser: per-line readline() capped the reader at
        # ~270k reads/s on one core -- far below what a multi-chip host
        # needs to feed.  A chunk's newline positions, line bounds,
        # whitespace strips, header checks, and qname token bounds are all
        # computed with numpy; sequence bytes get ONE LUT pass per chunk
        # with per-read views into it.  Parsed records are staged in
        # _store_* and handed out in list slices.
        self._eof = False
        self._stop = False                 # limit_offset tripped
        self._carry = b""                  # bytes after last parsed record
        self._pos = resume_offset          # absolute offset of _carry[0]
        self._prec = resume_record         # index of next record to parse
        self._trunc: int | None = None     # truncated-record index at EOF
        self._store_q: list = []
        self._store_c: list = []
        self._store_u: list = []
        self._store_s = np.empty(0, np.int64)   # record start offsets
        self._store_e = np.empty(0, np.int64)   # record end offsets
        self._store_i = 0

    def __iter__(self):
        return self

    def _parse_more(self) -> bool:
        """Parse the next chunk into the record store.  False at EOF."""
        while True:
            data = self._fh.read(self._CHUNK) if not self._eof else b""
            if not data:
                self._eof = True
            buf = self._carry + data if self._carry else data
            if not buf:
                return False
            arr = np.frombuffer(buf, dtype=np.uint8)
            nl = np.flatnonzero(arr == 10)
            unterm = self._eof and (len(nl) == 0
                                    or int(nl[-1]) != len(buf) - 1)
            n_lines = len(nl) + (1 if unterm else 0)
            k = n_lines // 4
            if k == 0:
                if self._eof:          # 1-3 dangling lines: truncated
                    self._trunc = self._prec
                    self._carry = b""
                    return False
                self._carry = buf      # need more data for one record
                continue
            if unterm:
                ls = np.concatenate(([0], nl + 1))
                le = np.concatenate((nl, [len(buf)]))
                raw_end = np.concatenate((nl + 1, [len(buf)]))
            else:
                ls = np.concatenate(([0], nl[:-1] + 1))
                le = nl.astype(np.int64)
                raw_end = nl + 1
            m = 4 * k
            hs, he = ls[0:m:4].astype(np.int64), le[0:m:4].astype(np.int64)
            ss, se = ls[1:m:4].astype(np.int64), le[1:m:4].astype(np.int64)
            qs, qe = ls[3:m:4].astype(np.int64), le[3:m:4].astype(np.int64)
            base = self._pos
            rec_start = base + hs
            rec_end = base + raw_end[3:m:4]
            consumed = int(raw_end[m - 1])
            self._carry = buf[consumed:]
            self._pos = base + consumed
            if self._eof and self._carry:      # dangling lines past last rec
                self._trunc = self._prec + k
            top = len(arr) - 1
            for s_, e_ in ((hs, he), (ss, se), (qs, qe)):
                while True:                    # rstrip (usually just \r)
                    w = (e_ > s_) & _WS[arr[np.maximum(e_ - 1, 0)]]
                    if not w.any():
                        break
                    e_[w] -= 1
                while True:                    # lstrip (usually a no-op)
                    w = (e_ > s_) & _WS[arr[np.minimum(s_, top)]]
                    if not w.any():
                        break
                    s_[w] += 1
            at_ok = (he > hs) & (arr[np.minimum(hs, top)] == ord("@"))
            if not at_ok.all():
                bad = int(np.flatnonzero(~at_ok)[0])
                htxt = buf[hs[bad]:he[bad]].decode()[:40]
                raise ValueError(f"bad FASTQ header at record "
                                 f"{self._prec + bad}: {htxt!r}")
            # qname = first whitespace-separated token after '@'
            ns = hs + 1
            while True:
                w = (ns < he) & _WS[arr[np.minimum(ns, top)]]
                if not w.any():
                    break
                ns[w] += 1
            ws_pos = np.flatnonzero(_WS[arr])
            wi = np.searchsorted(ws_pos, ns)
            cand = ws_pos[np.minimum(wi, max(len(ws_pos) - 1, 0))] \
                if len(ws_pos) else np.zeros(k, np.int64)
            ne = np.where((wi < len(ws_pos)) & (cand < he), cand, he)
            prec = self._prec
            # python ints before the comprehensions: slicing with boxed
            # numpy scalars is ~3x slower
            ns_l, ne_l, hs_l = ns.tolist(), ne.tolist(), hs.tolist()
            ss_l, se_l = ss.tolist(), se.tolist()
            qs_l, qe_l = qs.tolist(), qe.tolist()
            self._store_q = [
                buf[a:b].decode() if b - a0 > 1 else f"r{prec + i}"
                for i, (a, b, a0) in enumerate(zip(ns_l, ne_l, hs_l))]
            codes_chunk = dna.encode(buf)
            self._store_c = [codes_chunk[a:b] for a, b in zip(ss_l, se_l)]
            if self.phred64:
                qarr = np.maximum(arr.astype(np.int16) - 31,
                                  33).astype(np.uint8)
                self._store_u = [qarr[a:b].tobytes().decode()
                                 for a, b in zip(qs_l, qe_l)]
            else:
                self._store_u = [buf[a:b].decode()
                                 for a, b in zip(qs_l, qe_l)]
            self._store_s = rec_start
            self._store_e = rec_end
            self._store_i = 0
            self._prec = prec + k
            return True

    def __next__(self) -> ReadBatch:
        qnames: list = []
        codes: list = []
        quals: list = []
        start = self._record
        end_off = self._offset
        while len(qnames) < self.batch_size and not self._stop:
            if self.limit_records is not None \
                    and self._yielded + len(qnames) >= self.limit_records:
                break
            i0 = self._store_i
            if i0 >= len(self._store_q):
                if self._trunc is None and not self._eof \
                        and self._parse_more():
                    continue
                if self._trunc is not None and \
                        (self.limit_offset is None
                         or self._pos < self.limit_offset):
                    # reproduce the streaming reader's behavior: the raise
                    # happens in the batch that would contain the record,
                    # and only if the offset limit would let it be read
                    # (_pos is the truncated record's start offset)
                    raise ValueError(
                        f"truncated FASTQ record at {self._trunc}")
                break
            take = min(self.batch_size - len(qnames),
                       len(self._store_q) - i0)
            if self.limit_records is not None:
                take = min(take, self.limit_records - self._yielded
                           - len(qnames))
            if self.limit_offset is not None:
                ok = int(np.searchsorted(self._store_s[i0:i0 + take],
                                         self.limit_offset, side="left"))
                if ok < take:
                    self._stop = True
                    take = ok
            if take <= 0:
                break
            qnames += self._store_q[i0:i0 + take]
            codes += self._store_c[i0:i0 + take]
            quals += self._store_u[i0:i0 + take]
            end_off = int(self._store_e[i0 + take - 1])
            self._store_i = i0 + take
            self._record += take
        if not qnames:
            self._fh.close()
            raise StopIteration
        self._offset = end_off
        self._yielded += len(qnames)
        return ReadBatch(qnames, codes, quals, start, end_off)


def read_pairs(path1, path2, batch_size: int = 4096, phred64: bool = False,
               resume_offsets=(0, 0), resume_record: int = 0,
               limit_records: int | None = None):
    """Synchronized paired FASTQ iteration -> (batch1, batch2) tuples.

    Resumable from (per-file byte offsets, pair record index) -- the PE
    cursor checkpoint (SURVEY.md 5.3/5.4).  limit_records bounds BOTH mates
    (byte-range multi-host sharding: mate files are record-count aligned)."""
    r1 = FastqReader(path1, batch_size, phred64,
                     resume_offset=resume_offsets[0],
                     resume_record=resume_record,
                     limit_records=limit_records)
    r2 = FastqReader(path2, batch_size, phred64,
                     resume_offset=resume_offsets[1],
                     resume_record=resume_record,
                     limit_records=limit_records)
    while True:
        try:
            b1 = next(r1)
        except StopIteration:
            try:
                next(r2)
            except StopIteration:
                return
            raise ValueError("mate files have different read counts")
        try:
            b2 = next(r2)
        except StopIteration:
            raise ValueError("mate files have different read counts")
        if len(b1) != len(b2):
            raise ValueError("mate files have different read counts")
        yield b1, b2


class Prefetcher:
    """Decode-ahead iterator: a daemon thread pulls up to `depth` items from
    the wrapped iterator so FASTQ decode overlaps the device mapping round
    trip (SURVEY.md hard-part 7: host I/O must overlap device compute --
    the decode's numpy/zlib inner loops release the GIL).  Items arrive in
    order; an exception in the source re-raises at the consumer, after
    which iteration is over.  close() (also a context manager exit)
    unblocks and retires the thread when the consumer abandons the stream
    early -- without it the pump would sit blocked on the full queue,
    pinning the open FASTQ handle for the rest of the process.  The
    consumer's wait on the queue is span `io.read_wait`
    (utils/profiling)."""

    _DONE = object()

    def __init__(self, it, depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._finished = False

        def pump():
            try:
                for x in it:
                    while not self._stop.is_set():
                        try:
                            self._q.put(x, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
                self._q.put(self._DONE)
            except BaseException as e:  # propagate to the consumer
                try:
                    self._q.put(e, timeout=5)
                except queue.Full:
                    pass

        self._t = threading.Thread(target=pump, daemon=True,
                                   name="btbs-fastq-prefetch")
        self._t.start()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
        self._t.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        with span("io.read_wait"):
            x = self._q.get()
        if x is self._DONE:
            self._finished = True
            raise StopIteration
        if isinstance(x, BaseException):
            self._finished = True
            raise x
        return x


def write_fastq(path, reads, qnames=None, quals=None):
    """Test/fixture helper."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        for i, r in enumerate(reads):
            qn = qnames[i] if qnames else f"r{i}"
            q = quals[i] if quals else "I" * len(r)
            f.write(f"@{qn}\n{dna.decode(r)}\n+\n{q}\n")
