"""Multi-host runs: sharded FASTQ in, sharded SAM out, global stats
(counterpart of bitmapperbs_tpu/parallel/multihost.py).

Topology: every host runs the same CLI.  Host h of H either reads its own
byte range of the FASTQ (`plan_byte_range`: each host decodes ~1/H of it;
uncompressed input only) or reads every record and keeps records h, h+H,
h+2H, ... (`HostShard`: record striding, for .gz), maps them on its card,
and writes `<out>.shard<h>.sam`.  Shards concatenate to a complete record
set (order differs from input; each record is independent and tagged by
qname).  End-of-run counters are summed over hosts with one all_reduce of
seven integers over torch.distributed's gloo backend: host integers once
per run need no collective library of the card, and gloo takes any number
of processes on one machine, where NCCL refuses two ranks on one card.

Degrades exactly to the single-host path when the world size is 1.  The
pure-Python parts (HostShard, the byte-range planning, shard_path) are kept
equal to the reference's (tests/test_torch_copies.py).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from bitmapperbs_tpu_torch.io.stats import MapStats

STAT_NAMES = ("total", "mapped", "unique", "ambiguous", "unmapped",
              "proper_pairs", "overflow_reads")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the run's process group; returns (process_id, num_processes).

    With num_processes <= 1 this is a no-op returning (0, 1).  Otherwise a
    gloo group is initialised at tcp://<coordinator> (host:port, the address
    process 0 listens on), or from the environment (MASTER_ADDR /
    MASTER_PORT, env://) when no coordinator is given; a process_id of None
    reads RANK.  A host that cannot reach the coordinator times out inside
    init_process_group; the run then restarts from each host's output
    cursor."""
    if num_processes is None or num_processes <= 1:
        return 0, 1
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dist.init_process_group(
        "gloo", init_method=(f"tcp://{coordinator}" if coordinator
                             else "env://"),
        world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def finalize_distributed() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass
class HostShard:
    """Record-strided FASTQ shard assignment for this host."""

    process_id: int
    num_processes: int

    def owns(self, record_index: int) -> bool:
        return record_index % self.num_processes == self.process_id

    def filter_batch(self, codes, qnames, quals, start_record: int):
        keep = [i for i in range(len(codes))
                if self.owns(start_record + i)]
        return ([codes[i] for i in keep], [qnames[i] for i in keep],
                [quals[i] for i in keep])


def _snap_record_start(path: str, target: int) -> int:
    """Smallest FASTQ record-start byte offset >= (roughly) target.

    Record-start detection: a line is a record header iff it starts with
    '@' AND the line two below starts with '+' (quality lines may start
    with '@' but are always followed by header->sequence, and sequence
    lines never start with '+').  Deterministic, so all hosts computing
    adjacent boundaries agree and ranges tile exactly.
    """
    size = os.path.getsize(path)
    if target <= 0:
        return 0
    if target >= size:
        return size
    with open(path, "rb") as f:
        f.seek(target)
        f.readline()                      # skip the (possibly) partial line
        offs, lines = [], []
        for _ in range(8):
            offs.append(f.tell())
            line = f.readline()
            if not line:
                break
            lines.append(line)
        for i in range(min(4, len(lines))):
            if lines[i][:1] == b"@" and i + 2 < len(lines) \
                    and lines[i + 2][:1] == b"+":
                return offs[i]
    return size


def _count_newlines(path: str, lo: int, hi: int) -> int:
    """Newlines in bytes [lo, hi) -- block reads + bytes.count, no decode
    (~50-100x cheaper than the FASTQ decode path)."""
    n = 0
    with open(path, "rb") as f:
        f.seek(lo)
        left = hi - lo
        while left > 0:
            chunk = f.read(min(1 << 24, left))
            if not chunk:
                break
            n += chunk.count(b"\n")
            left -= len(chunk)
    return n


def _offset_of_record(path: str, record_index: int) -> int:
    """Byte offset of FASTQ record `record_index` (scan: newline counting)."""
    need = 4 * record_index
    if need == 0:
        return 0
    off = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 24)
            if not chunk:
                return off
            c = chunk.count(b"\n")
            if c >= need:
                nl = np.flatnonzero(
                    np.frombuffer(chunk, np.uint8) == ord("\n"))
                return off + int(nl[need - 1]) + 1
            need -= c
            off += len(chunk)


@dataclasses.dataclass
class ByteRangePlan:
    """Per-host byte-range FASTQ shard (SURVEY.md 2.2 DCN row).

    Unlike record-striding (HostShard), each host reads and DECODES only
    its ~1/H byte range; planning costs one boundary snap plus a newline
    scan of the range/prefix (no decode).  Uncompressed FASTQ only --
    .gz cannot seek, use record striding or per-host files there.
    """

    start_record: int          # global index of this host's first record
    offset: int                # mate-1 start byte
    limit_offset: int          # mate-1 end byte (exclusive; snapped)
    n_records: int             # records owned by this host
    offset2: int = 0           # mate-2 start byte (PE)


def plan_byte_range(path: str, process_id: int, num_processes: int,
                    path2: str | None = None) -> ByteRangePlan:
    """Byte-range shard plan for host `process_id` of `num_processes`.

    SE: equal byte ranges snapped to record starts; the host decodes only
    [offset, limit_offset).  PE: ranges are chosen on mate-1 and mate 2 is
    aligned by RECORD COUNT (mate files need not have equal byte layouts);
    the alignment scan is newline counting only.
    """
    size = os.path.getsize(path)
    lo = _snap_record_start(path, size * process_id // num_processes)
    hi = _snap_record_start(path, size * (process_id + 1) // num_processes)
    start_record = _count_newlines(path, 0, lo) // 4
    n_records = _count_newlines(path, lo, hi) // 4
    plan = ByteRangePlan(start_record=start_record, offset=lo,
                         limit_offset=hi, n_records=n_records)
    if path2 is not None:
        plan.offset2 = _offset_of_record(path2, start_record)
    return plan


def shard_path(output: str, process_id: int, num_processes: int) -> str:
    if num_processes == 1:
        return output
    base = output[:-4] if output.endswith(".sam") else output
    return f"{base}.shard{process_id}.sam"


def global_stats(stats: MapStats) -> dict:
    """Sum per-host counters over all hosts: one all_reduce (SUM) of the
    seven int64 counters as a CPU tensor; this host's own counters when no
    process group was joined."""
    vals = torch.tensor([getattr(stats, k) for k in STAT_NAMES],
                        dtype=torch.int64)
    if dist.is_initialized():
        dist.all_reduce(vals, op=dist.ReduceOp.SUM)
    return {k: int(v) for k, v in zip(STAT_NAMES, vals.tolist())}
