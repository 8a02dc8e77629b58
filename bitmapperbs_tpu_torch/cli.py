"""Command-line entry point of the PyTorch port:

    python -m bitmapperbs_tpu_torch index  ref.fa [--prefix P]
    python -m bitmapperbs_tpu_torch search ref.fa --seq r.fq [options]  (SE)
    python -m bitmapperbs_tpu_torch search ref.fa --pe --seq1 r1.fq \
        --seq2 r2.fq [options]                                         (PE)
    python -m bitmapperbs_tpu_torch resample P [--sa-rate R] [--out Q]

Counterpart of bitmapperbs_tpu/cli.py, with the same options: the parser,
`index`, `resample`, config building, genome-size autotune and the per-read
budget grouping are kept equal to the reference CLI's.  `search` runs the
one mapping loop, models/host.map_reader_batches, over the FASTQ reader's
batches, SE and PE alike: it maps single-end reads through
models/host.map_batch and pairs through models/host.map_batch_pe on the
GPUs (`--platform auto|gpu`) or, when asked for explicitly, on the CPU
(`--platform cpu`); `--oracle` maps through the numpy oracle on the host
instead.  With more than one local card and no
`--single-device`, batches are split over every card (parallel/shard.py),
the index replicated on each, or split over `--shard-index N` cards per
data slice.  On one card a full batch replays a CUDA graph of its device
call (models/graphs.py), under `--profile` too.

Streaming runs checkpoint a (record, byte-offset) cursor next to the output,
`<out>.cursor`, after every written group (the reference's JSON: a run
killed under either package resumes under the other with `--resume`).
`--profile DIR` runs with utils/profiling's recorder on and writes a
torch.profiler Chrome trace of the graphed path: the card's kernels,
replays included, the host loop's spans as `btbs.*` ranges and one track
per finalize worker; it prints the stage line: the map (`host.call`) and
write (`io.write`) walls, every other span's, the graph captures, replays
and replayed launches, the eager calls by reason, and the records and
characters of SAM text that came back from the finalize pool (`-t`).
`--dist-hosts N`
maps one shard of the input per process (parallel/multihost.py).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from functools import partial


PLATFORMS = ("auto", "cpu", "gpu")
STAGES = {"host.call": "map", "io.write": "write"}   # --profile's stage line


def _translate_legacy(argv):
    if argv and argv[0] in ("--index", "--search"):
        return [argv[0][2:]] + argv[1:]
    return argv


def build_parser():
    from bitmapperbs_tpu_torch.io.sam import VERSION

    ap = argparse.ArgumentParser(prog="bitmapperbs_tpu_torch",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--version", action="version",
                    version=f"bitmapperbs_tpu_torch {VERSION}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ix = sub.add_parser("index", help="build the bisulfite FM-index")
    ix.add_argument("ref")
    ix.add_argument("--prefix", default=None,
                    help="index output prefix (default: <ref>.btidx)")
    ix.add_argument("--sa-rate", type=int, default=None,
                    help="SA sample rate (default: 4 for <=134 Mbp, else 8; "
                         "lower = faster locate, more HBM)")
    ix.add_argument("--klt-k", type=int, default=None,
                    help="k-mer lookup table depth (default: genome-size "
                         "adaptive, <= 14)")
    ix.add_argument("-t", "--threads", type=int, default=1,
                    help="build the two FM blocks (CT(W), CT(rc W)) in "
                         "parallel worker processes (>=2 halves the "
                         "suffix-array wall time; needs RAM for two "
                         "concurrent builds)")
    ix.add_argument("--build-mode", choices=("auto", "sais", "lowmem"),
                    default="auto",
                    help="sais: in-RAM suffix array (~12 B/char); lowmem: "
                         "native dynamic-BWT insertion, no suffix array "
                         "(~1 B/char peak -- whole-genome builds on small "
                         "hosts); auto picks by genome size")

    rs = sub.add_parser(
        "resample",
        help="densify an index's SA samples (halve sa-rate) in place -- "
             "faster locate without rebuilding the suffix array")
    rs.add_argument("prefix", help="index prefix (from `index`)")
    rs.add_argument("--sa-rate", type=int, default=None,
                    help="target rate (default: half the current rate; must "
                         "be current/2^k)")
    rs.add_argument("--out", default=None,
                    help="output prefix (default: rewrite in place)")

    se = sub.add_parser("search", help="map reads")
    se.add_argument("ref")
    se.add_argument("--seq", help="single-end FASTQ(.gz)")
    se.add_argument("--seq1", help="paired-end mate 1")
    se.add_argument("--seq2", help="paired-end mate 2")
    se.add_argument("--pe", action="store_true", help="paired-end mode")
    se.add_argument("-o", "--output", default="-", help="SAM output (default stdout)")
    se.add_argument("--bam", action="store_true",
                    help="write BAM instead of SAM (also implied by a .bam "
                         "output path)")
    se.add_argument("-e", "--max-errors", type=float, default=4,
                    help="error budget: an integer = max edit distance; a "
                         "fraction in (0,1) = error rate, resolved as "
                         "floor(rate * first-read length) (min 1)")
    se.add_argument("--no-indels", action="store_true",
                    help="Hamming-only mode (mismatches, no gaps)")
    se.add_argument("--min", dest="min_insert", type=int, default=0)
    se.add_argument("--max", dest="max_insert", type=int, default=1000)
    se.add_argument("--pbat", "--non-directional", dest="non_directional",
                    action="store_true")
    se.add_argument("--fast", action="store_true",
                    help="sensitivity preset: fewer candidates")
    se.add_argument("--sensitive", action="store_true",
                    help="sensitivity preset: more candidates")
    se.add_argument("--seed-ext", type=int, default=None, metavar="N",
                    help="adaptive seed extension: a heavy seed grows left "
                         "by up to N chars until its interval is small "
                         "(default: auto -- 20 for genomes over 512 Mbp, "
                         "else off; 0 disables)")
    se.add_argument("--seed-ext-occ", type=int, default=4, metavar="T",
                    help="extension stops once a seed's interval holds <= T "
                         "occurrences (with --seed-ext)")
    se.add_argument("--max-candidates", type=int, default=None, metavar="K",
                    help="verified anchors per read per (pattern, block) "
                         "(default: auto -- 128 for genomes over 512 Mbp, "
                         "else 64)")
    se.add_argument("-t", "--threads", type=int, default=1,
                    help="host IO worker threads (device does the mapping)")
    se.add_argument("--batch-size", type=int, default=4096)
    se.add_argument("--flat-chunks", type=int, default=None, metavar="N",
                    help="accepted for the reference CLI's sake and "
                         "ignored: locate and verify always stop at the "
                         "candidate buffer's fill on the card")
    se.add_argument("--read-bucket", type=int, default=None,
                    help="padded read length (multiple of 32; default: "
                         "sized from the first reads -- shorter buckets map "
                         "proportionally faster)")
    se.add_argument("--phred64", action="store_true")
    se.add_argument("--unmapped-out", default=None,
                    help="write unmapped reads to this FASTQ")
    se.add_argument("--ambiguous-out", default=None,
                    help="write ambiguous (MAPQ 0) reads to this FASTQ")
    se.add_argument("--suppress-ambiguous", action="store_true",
                    help="do not report multi-mapping (MAPQ 0) reads")
    se.add_argument("--stats-json", default=None)
    se.add_argument("--resume", action="store_true",
                    help="resume from the output's cursor checkpoint")
    se.add_argument("--dist-hosts", type=int, default=1,
                    help="number of hosts in a multi-host (pod) run")
    se.add_argument("--dist-host-id", type=int, default=None,
                    help="this host's process id (default: auto)")
    se.add_argument("--dist-coordinator", default=None,
                    help="coordinator address host:port of a multi-host run")
    se.add_argument("--dist-shard", choices=("auto", "bytes", "records"),
                    default="auto",
                    help="multi-host input sharding: 'bytes' = per-host "
                         "byte ranges (each host decodes ~1/H of the FASTQ; "
                         "uncompressed only), 'records' = record striding "
                         "(every host decodes everything, keeps 1/H); auto "
                         "picks bytes unless input is .gz")
    se.add_argument("--shard-index", type=int, default=0, metavar="N",
                    help="shard the index over N chips (HBM relief for "
                         "genomes larger than one chip; must divide the "
                         "local device count; default 0 = replicated)")
    se.add_argument("--single-device", action="store_true",
                    help="map on one chip even when more are attached")
    se.add_argument("--platform", choices=PLATFORMS, default="auto",
                    help="auto/gpu: the CUDA device (exit 2 when there is "
                         "none); cpu: the plain PyTorch path on the host")
    se.add_argument("--profile", default=None, metavar="DIR",
                    help="write a profiler trace to DIR")
    se.add_argument("--oracle", action="store_true",
                    help="use the pure-CPU numpy oracle path (debug)")
    se.add_argument("--rg", default=None, help="read group id")
    return ap


def default_prefix(ref):
    return ref + ".btidx"


def cmd_index(args) -> int:
    from bitmapperbs_tpu_torch.index.build import build_index, save_index

    prefix = args.prefix or default_prefix(args.ref)
    t0 = time.time()
    idx = build_index(args.ref, sa_rate=args.sa_rate, klt_k=args.klt_k,
                      build_mode=args.build_mode, jobs=args.threads)
    save_index(idx, prefix)
    sys.stderr.write(
        f"[bitmapperbs_tpu_torch] indexed {sum(idx.genome.lengths)} bp "
        f"({len(idx.genome.names)} contigs) in {time.time() - t0:.1f}s "
        f"-> {prefix}.bin ({idx.nbytes() / 1e6:.0f} MB)\n")
    return 0


def make_config(args):
    from bitmapperbs_tpu_torch.config import AlignerConfig

    e = args.max_errors
    if not 0 < e < 1 and e != int(e):
        raise SystemExit(f"error: -e must be an integer or a rate in (0,1), "
                         f"got {e}")
    cfg = AlignerConfig(
        max_errors=int(e),
        indels=not args.no_indels,
        non_directional=args.non_directional,
        paired=bool(args.pe),
        min_insert=args.min_insert,
        max_insert=args.max_insert,
        batch_size=args.batch_size,
        read_len_bucket=args.read_bucket,
        report_ambiguous=not args.suppress_ambiguous,
        sam_rg=args.rg,
    )
    if getattr(args, "flat_chunks", None) is not None:
        cfg = cfg.replace(flat_chunks=args.flat_chunks)
    if args.fast:
        cfg = cfg.replace(max_seed_occ=32, locate_budget=64, max_candidates=16)
    if args.sensitive:
        cfg = cfg.replace(max_seed_occ=512, locate_budget=512,
                          max_candidates=128)
    if getattr(args, "seed_ext", None) is not None:
        cfg = cfg.replace(seed_ext_max=args.seed_ext,
                          seed_ext_occ=args.seed_ext_occ)
    if getattr(args, "max_candidates", None) is not None:
        cfg = cfg.replace(max_candidates=args.max_candidates)
    cfg.validate()
    return cfg


def autotune_for_genome(cfg, args, genome_bp: int):
    """Genome-size config auto-tune (SURVEY.md C9).  At Gbp scale the
    3-letter alphabet makes T-rich seeds heavy-tailed: measured at 3.08 Gbp,
    mean candidate occupancy is ~259 entries/read and the default caps
    collapse recall to 0.59.  Adaptive seed extension (grow heavy seeds
    until <= 4 occurrences, <= 20 chars) cuts occupancy to ~78 and, with
    max_candidates 128, restores recall to 0.989 -- above even the
    cap-512 dense sweep (0.988) at a third of the candidate volume
    (PERF.md round-3 3 Gbp study).  Explicit flags always win."""
    if genome_bp <= 512_000_000:
        return cfg
    tuned = []
    # The small-genome presets are HARMFUL at Gbp scale (the reference
    # package's study on its 3 Gbp repeat artifact; recall is a count and
    # carries over, its TPU rates do not): --fast's tiny caps drop recall
    # to 0.83 without being faster there, and --sensitive's occ/LB flood
    # gdrops 14% of reads into host dense reruns (device recall 0.77).
    # Remap them onto the adaptive-seeding regime's real lever, the
    # candidate cap: recall is monotone over Kc64 / 128 / 256-2chunks.
    explicit_kc = getattr(args, "max_candidates", None) is not None
    if getattr(args, "fast", False):
        cfg = cfg.replace(max_seed_occ=128, locate_budget=256)
        if not explicit_kc:
            cfg = cfg.replace(max_candidates=64)
        tuned.append("fast -> Kc64 (Gbp regime)")
    if getattr(args, "sensitive", False):
        cfg = cfg.replace(max_seed_occ=128, locate_budget=256)
        if not explicit_kc:
            cfg = cfg.replace(max_candidates=256)
        if getattr(args, "flat_chunks", None) is None:
            cfg = cfg.replace(flat_chunks=max(cfg.flat_chunks, 2))
        tuned.append("sensitive -> Kc256 (Gbp regime)")
    if getattr(args, "seed_ext", None) is None and cfg.seed_ext_max == 0:
        cfg = cfg.replace(seed_ext_max=20,
                          seed_ext_occ=getattr(args, "seed_ext_occ", 4))
        tuned.append(f"seed-ext {cfg.seed_ext_max} "
                     f"(occ<={cfg.seed_ext_occ})")
    if (getattr(args, "max_candidates", None) is None
            and not getattr(args, "fast", False)
            and not getattr(args, "sensitive", False)):
        cfg = cfg.replace(max_candidates=128)
        tuned.append("max-candidates 128")
    if (cfg.non_directional and cfg.locate_flat_cap == 0
            and getattr(args, "flat_chunks", None) is None):
        # 4 frames carry ~2x the SE occupancy (~156/read measured at
        # 3.08 Gbp with extension): above flat_cap_max=128, so PBAT would
        # gdrop ~22% of reads into dense reruns; 192 slots measured
        # gdrop-free at recall 0.9893 (flat_chunks as the reference sets
        # it; the port ignores it)
        cfg = cfg.replace(locate_flat_cap=192, flat_chunks=3)
        tuned.append("flat-cap 192")
    if tuned:
        sys.stderr.write(f"[bitmapperbs_tpu_torch] {genome_bp/1e9:.2f} Gbp genome:"
                         f" auto-tuned {', '.join(tuned)}\n")
    return cfg


def cmd_resample(args) -> int:
    from bitmapperbs_tpu_torch.index.build import load_index, save_index
    from bitmapperbs_tpu_torch.index.resample import halve_sa_rate

    t0 = time.time()
    # mmap=False: densification rewrites cp_rows in place; a v4 mmap view
    # is read-only
    idx = load_index(args.prefix, mmap=False)
    old = idx.blocks[0].sa_rate
    halve_sa_rate(idx, args.sa_rate)
    save_index(idx, args.out or args.prefix)
    sys.stderr.write(
        f"[bitmapperbs_tpu_torch] sa_rate {old} -> {idx.blocks[0].sa_rate} "
        f"({idx.nbytes() / 1e6:.0f} MB) in {time.time() - t0:.1f}s\n")
    return 0


MAX_READ_LEN = 1024   # short-read aligner (SURVEY.md: WGBS reads 50-300 bp)


def _budget_for(rate: float, length: int) -> int:
    """Per-read -e rate resolution: floor(rate*len) (SURVEY.md 2.1 'max
    errors or error rate').  A resolved budget beyond the config maximum
    fails loudly -- silently clamping would unmap reads the user's rate
    promises to tolerate."""
    b = max(1, int(rate * length))
    if b > 15:
        raise SystemExit(f"error: -e {rate} resolves to max_errors={b} for "
                         f"a {length} bp read (limit 15); use a smaller "
                         f"rate or an explicit integer -e")
    return b


def _cfg_key(cfg, rate, length: int):
    """Per-read static-config key (error budget, padded-length bucket).

    Budget: -e rate mode resolves floor(rate*len) per read.  Bucket: grows
    in 32-wide steps beyond the base bucket so a longer read later in the
    file maps in its own group instead of aborting the run; SURVEY.md 5.7
    'bucketing + masked batching'."""
    if length > MAX_READ_LEN:
        raise SystemExit(f"error: read of {length} bp exceeds the "
                         f"{MAX_READ_LEN} bp short-read limit")
    b = _budget_for(rate, length) if rate is not None else cfg.max_errors
    bk = max(cfg.read_len_bucket, -(-length // 32) * 32)
    return (b, bk)


# The benchmark's window (wgbs_bench/run.py) calls these two; cmd_search
# calls models/host.map_grouped through host.map_reader_batches.
def _map_grouped_se(run, cfg, rate, codes, quals, qnames):
    from bitmapperbs_tpu_torch.models.host import map_grouped
    return map_grouped(run, cfg, partial(_cfg_key, cfg, rate), codes, quals,
                       qnames)


def _map_grouped_pe(run, cfg, rate, prs, quals, qn):
    from bitmapperbs_tpu_torch.models.host import map_grouped
    return map_grouped(run, cfg, partial(_cfg_key, cfg, rate), prs, quals,
                       qn, mates=2)


def _closing_iter(pf):
    """Yield from a Prefetcher, closing it when iteration stops for ANY
    reason (exhaustion, break, or an exception unwinding the caller) --
    the generator's finally runs when its frame is released, so the pump
    thread and its open FASTQ handle never outlive an aborted run."""
    try:
        yield from pf
    finally:
        pf.close()



def _local_devices(platform: str) -> list:
    """The devices `search` maps on: the CPU for `--platform cpu`, else
    every CUDA device (none without CUDA)."""
    import torch

    from bitmapperbs_tpu_torch.parallel.mesh import local_devices

    return [torch.device("cpu")] if platform == "cpu" else local_devices()


def cmd_search(args) -> int:
    if args.pe and not (args.seq1 and args.seq2):
        sys.stderr.write("error: --pe requires --seq1 and --seq2\n")
        return 2
    if not args.pe and not args.seq:
        sys.stderr.write("error: single-end search requires --seq\n")
        return 2
    # --oracle maps on the host by definition: it needs no card
    devices = [] if args.oracle else _local_devices(args.platform)
    if not devices and not args.oracle:
        sys.stderr.write(f"error: --platform {args.platform}: no CUDA device"
                         f" available (use --platform cpu for a host run)\n")
        return 2
    device = devices[0] if devices else None

    from bitmapperbs_tpu_torch import constants as K
    from bitmapperbs_tpu_torch.index.build import load_index
    from bitmapperbs_tpu_torch.io.fastq import (FastqReader, Prefetcher,
                                                read_pairs, write_fastq)
    from bitmapperbs_tpu_torch.io.sam import SamWriter
    from bitmapperbs_tpu_torch.io.stats import MapStats
    from bitmapperbs_tpu_torch.parallel import multihost
    from bitmapperbs_tpu_torch.utils.profiling import (REC, device_trace,
                                                       report, span,
                                                       trace_path)

    # ref may be the FASTA path (resolves <ref>.btidx) or an index prefix
    for prefix in (default_prefix(args.ref), args.ref,
                   re.sub(r"\.(bin|npz)$", "", args.ref)):
        if os.path.exists(prefix + ".json"):
            break
    else:
        sys.stderr.write(f"error: index not found at "
                         f"{default_prefix(args.ref)}.json (run: python -m "
                         f"bitmapperbs_tpu_torch index {args.ref})\n")
        return 2
    inputs = (args.seq1, args.seq2) if args.pe else (args.seq,)
    if args.read_bucket is None:
        # size the padded-length bucket from the head of the input(s)
        lens = []
        for path in inputs:
            head = next(iter(FastqReader(path, batch_size=1024)), None)
            if head is not None:
                lens.extend(len(c) for c in head.codes)
        mx = max(lens) if lens else 160
        args.read_bucket = max(32, -(-mx // 32) * 32)
        sys.stderr.write(f"[bitmapperbs_tpu_torch] read bucket auto-sized to "
                         f"{args.read_bucket} (longest head read {mx} bp)\n")
    error_rate = None
    if 0 < args.max_errors < 1:
        # -e as an error rate: budgets resolve per read (floor(rate * len))
        first = next(iter(FastqReader(inputs[0], batch_size=1)), None)
        if first is None or not len(first.codes):
            sys.stderr.write("error: empty FASTQ\n")
            return 2
        error_rate = args.max_errors
        args.max_errors = _budget_for(error_rate, len(first.codes[0]))
        sys.stderr.write(f"[bitmapperbs_tpu_torch] -e {error_rate} -> "
                         f"per-read max_errors=floor(rate*len) (first read: "
                         f"{args.max_errors} at {len(first.codes[0])} bp)\n")
    cfg = make_config(args)
    idx = load_index(prefix)
    cfg = autotune_for_genome(cfg, args, int(sum(idx.genome.lengths)))
    if not args.oracle and args.shard_index and (
            len(devices) < 2 or args.single_device):
        sys.stderr.write("error: --shard-index needs >1 local device\n")
        return 2

    bam = args.bam or args.output.endswith(".bam")
    if bam and args.output == "-":
        sys.stderr.write("error: --bam requires -o FILE\n")
        return 2

    # multi-host: per-host FASTQ shard (byte ranges by default -- each host
    # decodes ~1/H; record striding for .gz), per-host SAM shard, global
    # stats summed over hosts at the end
    shard = range_plan = None
    if args.dist_hosts > 1:
        gz = any(str(p).endswith(".gz") for p in inputs)
        mode = args.dist_shard
        if mode == "auto":
            mode = "records" if gz else "bytes"
        elif mode == "bytes" and gz:
            # byte-range planning works on uncompressed offsets only; on a
            # .gz the plan would be computed in compressed space while the
            # reader seeks decompressed offsets -> silent record loss
            raise SystemExit("error: --dist-shard bytes requires "
                             "uncompressed FASTQ inputs (use 'records' or "
                             "'auto' for .gz)")
        pid, nproc = multihost.init_distributed(
            args.dist_coordinator, args.dist_hosts, args.dist_host_id)
        if mode == "bytes":
            range_plan = multihost.plan_byte_range(
                inputs[0], pid, nproc, path2=args.seq2 if args.pe else None)
        else:
            shard = multihost.HostShard(pid, nproc)
        if args.output != "-":
            args.output = multihost.shard_path(args.output, pid, nproc)
        sys.stderr.write(f"[bitmapperbs_tpu_torch] host {pid}/{nproc} "
                         f"({mode}) -> {args.output}\n")

    # resume cursor next to the output: where the reader restarts and how
    # much of the output is acknowledged; the same JSON as the reference's
    cursor_path = (args.output + ".cursor") if args.output != "-" else None
    resume = {"record": 0, "offset": 0, "out_pos": 0}
    if range_plan is not None:   # shard start; a cursor overrides it below
        resume = {"record": range_plan.start_record,
                  "offset": range_plan.offset,
                  "offset2": range_plan.offset2, "out_pos": 0}
    resumed = args.resume and cursor_path and os.path.exists(cursor_path)
    if resumed:
        with open(cursor_path) as f:
            resume = json.load(f)
        # a crash can land between the output flush and the cursor write:
        # truncating the output to the cursor's byte position (a record
        # boundary, a BGZF block boundary for BAM: save_cursor flushes the
        # writer first) drops what the cursor does not acknowledge
        if resume.get("out_pos") is not None and os.path.exists(args.output):
            with open(args.output, "r+b") as f:
                f.truncate(resume["out_pos"])
        sys.stderr.write(f"[bitmapperbs_tpu_torch] resuming at record "
                         f"{resume['record']}\n")

    from bitmapperbs_tpu_torch.models.host import (map_batch, map_batch_pe,
                                                   map_reader_batches)

    # finalize workers are spawned (numpy only) before the device is touched
    pool = dix = mappers = None
    if not args.oracle:
        from bitmapperbs_tpu_torch.index.device import upload_index
        from bitmapperbs_tpu_torch.models.pool import make_finalize_pool
        from bitmapperbs_tpu_torch.parallel.shard import make_cli_mappers
        pool = make_finalize_pool(idx, cfg, args.threads)
        if len(devices) > 1 and not args.single_device:
            # every local card: the index replicated on each, or split
            # over --shard-index N cards per data slice
            try:
                mappers = make_cli_mappers(idx, cfg, devices,
                                           shard_index=args.shard_index)
            except ValueError as e:
                if pool is not None:
                    pool.terminate()
                sys.stderr.write(f"error: {e}\n")
                return 2
            sys.stderr.write(
                f"[bitmapperbs_tpu_torch] mapping over {len(devices)} "
                f"devices (mesh {mappers.mesh.shape})\n")
        else:
            dix = upload_index(idx, device)

    # per-group mapper sets (-e rate budgets / grown length buckets) share
    # the base mappers' mesh and uploaded index
    group_mappers = {}

    def mappers_for(c):
        key = (c.max_errors, c.read_len_bucket)
        if mappers is None or key == (cfg.max_errors, cfg.read_len_bucket):
            return mappers
        if key not in group_mappers:
            group_mappers[key] = make_cli_mappers(idx, c, reuse=mappers)
        return group_mappers[key]

    out_fh = sys.stdout if args.output == "-" else open(
        args.output,
        ("ab" if bam else "a") if resumed else ("wb" if bam else "w"))
    stats = MapStats()
    unmapped, ambiguous = [], []
    t0 = time.time()
    cl = "bitmapperbs_tpu_torch " + " ".join(sys.argv[1:])
    if bam:
        from bitmapperbs_tpu_torch.io.bam import BamWriter
        writer = BamWriter(out_fh, idx.genome.names, idx.genome.lengths,
                           rg=args.rg, cl=cl, write_header=not resumed)
    elif not resumed:
        writer = SamWriter(out_fh, idx.genome.names, idx.genome.lengths,
                           rg=args.rg, cl=cl)
    else:                        # appending: no second header
        writer = SamWriter.__new__(SamWriter)
        writer.fh = out_fh

    def emit(records, reads, qnames, quals):
        for rec, r, qn, q in zip(records, reads, qnames, quals):
            writer.write(rec)
            stats.add_record(rec)
            if args.unmapped_out and rec.flag & K.FLAG_UNMAPPED:
                unmapped.append((r, qn, q))
            if args.ambiguous_out and rec.mapq == 0 \
                    and not rec.flag & K.FLAG_UNMAPPED:
                ambiguous.append((r, qn, q))

    def save_cursor(record, offset, offset2=0):
        if cursor_path:
            writer.flush()  # out_pos must be a record/BGZF-block boundary
            # atomic replace: a SIGKILL mid-write never leaves a torn cursor
            with open(cursor_path + ".tmp", "w") as f:
                json.dump({"record": record, "offset": offset,
                           "offset2": offset2, "out_pos": out_fh.tell()}, f)
            os.replace(cursor_path + ".tmp", cursor_path)

    if args.oracle:
        from bitmapperbs_tpu_torch.oracle.paired import map_batch_pe as ope
        from bitmapperbs_tpu_torch.oracle.pipeline import map_batch_se as ose
        oracle = ope if args.pe else ose

        def run(c, units, quals, qnames):
            return oracle(idx, c, units, quals, qnames)
    else:
        mapper = map_batch_pe if args.pe else map_batch

        def run(c, units, quals, qnames):
            return mapper(idx, dix, c, units, quals, qnames, stats=stats,
                          pool=pool, mappers=mappers_for(c), graphs=True)

    try:
        if args.pe:
            limit_records = None
            if range_plan is not None:
                limit_records = range_plan.n_records - (
                    resume["record"] - range_plan.start_record)
            batches = read_pairs(
                args.seq1, args.seq2, cfg.batch_size, args.phred64,
                resume_offsets=(resume["offset"], resume.get("offset2", 0)),
                resume_record=resume["record"], limit_records=limit_records)
        else:
            batches = FastqReader(
                args.seq, cfg.batch_size, args.phred64,
                resume_offset=resume["offset"],
                resume_record=resume["record"],
                limit_offset=(range_plan.limit_offset
                              if range_plan is not None else None))
        with device_trace(args.profile, device):
            # SE groups `threads` reader batches a call so the finalize
            # pool has cross-batch work; a PE call's batch is split over
            # the pool (host.task_slices); the cursor moves per call
            for recs, reads, qnames, quals, cursor in map_reader_batches(
                    cfg, _closing_iter(Prefetcher(batches)), run,
                    partial(_cfg_key, cfg, error_rate),
                    per_call=1 if args.pe else max(1, args.threads),
                    keep=shard.filter_batch if shard is not None else None):
                if not reads:       # a batch of other hosts' records
                    save_cursor(*cursor)
                    continue
                with span("io.write"):
                    emit(recs, reads, qnames, quals)
                    out_fh.flush()
                    save_cursor(*cursor)
        if args.profile:
            sys.stderr.write(f"[bitmapperbs_tpu_torch] profiler trace -> "
                             f"{trace_path(args.profile)}\n"
                             f"[bitmapperbs_tpu_torch] stages: "
                             f"{report(REC.snapshot(), STAGES)}\n")
        if bam:
            writer.close()
        stats.report(wall_s=time.time() - t0)
        if shard is not None:
            sys.stderr.write(f"[bitmapperbs_tpu_torch] global (all "
                             f"{args.dist_hosts} hosts): "
                             f"{multihost.global_stats(stats)}\n")
    finally:
        if pool is not None:
            pool.terminate()
        multihost.finalize_distributed()
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            f.write(stats.to_json() + "\n")
    if args.unmapped_out and unmapped:
        write_fastq(args.unmapped_out, *map(list, zip(*unmapped)))
    if args.ambiguous_out and ambiguous:
        write_fastq(args.ambiguous_out, *map(list, zip(*ambiguous)))
    if out_fh is not sys.stdout:
        out_fh.close()
    if cursor_path and os.path.exists(cursor_path):
        os.unlink(cursor_path)   # completed: drop the resume cursor
    return 0


def main(argv=None) -> int:
    argv = _translate_legacy(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.cmd == "index":
        return cmd_index(args)
    if args.cmd == "resample":
        return cmd_resample(args)
    return cmd_search(args)


if __name__ == "__main__":
    sys.exit(main())
