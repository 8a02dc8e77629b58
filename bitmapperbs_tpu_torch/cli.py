"""Command-line entry point of the PyTorch port:

    python -m bitmapperbs_tpu_torch index  ref.fa [--prefix P]
    python -m bitmapperbs_tpu_torch search ref.fa --seq r.fq [options]  (SE)
    python -m bitmapperbs_tpu_torch search ref.fa --pe --seq1 r1.fq \
        --seq2 r2.fq [options]                                         (PE)

The parser, `index`, config building, genome-size autotune and the per-read
budget grouping are the reference CLI's (bitmapperbs_tpu/cli.py); `search`
maps single-end reads through models/host.map_batch and pairs through
models/host.map_batch_pe on one GPU (`--platform auto|gpu`) or, when asked
for explicitly, on the CPU (`--platform cpu`).  Options of the reference
that this port does not run yet exit 2.
"""
from __future__ import annotations

import os
import re
import sys
import time

from bitmapperbs_tpu.cli import (_budget_for, _closing_iter, _map_grouped_pe,
                                 _map_grouped_se, _translate_legacy,
                                 autotune_for_genome, build_parser, cmd_index,
                                 default_prefix, make_config)

PLATFORMS = ("auto", "cpu", "gpu")


def _parser():
    ap = build_parser()
    ap.prog = "bitmapperbs_tpu_torch"
    sub = next(a for a in ap._actions if a.dest == "cmd")
    for act in sub.choices["search"]._actions:
        if act.dest == "platform":
            act.choices = PLATFORMS
            act.help = ("auto/gpu: the CUDA device (exit 2 when there is "
                        "none); cpu: the plain PyTorch path on the host")
    return ap


def _unported(args) -> str | None:
    for flag, on in (("--dist-hosts", args.dist_hosts > 1),
                     ("--shard-index", args.shard_index),
                     ("--profile", args.profile is not None),
                     ("--oracle", args.oracle), ("--resume", args.resume)):
        if on:
            return flag
    return None


def _device(platform: str):
    import torch

    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def cmd_search(args) -> int:
    flag = _unported(args)
    if flag is not None:
        sys.stderr.write(f"error: {flag} is not yet ported (ROADMAP.md)\n")
        return 2
    if args.pe and not (args.seq1 and args.seq2):
        sys.stderr.write("error: --pe requires --seq1 and --seq2\n")
        return 2
    if not args.pe and not args.seq:
        sys.stderr.write("error: single-end search requires --seq\n")
        return 2
    device = _device(args.platform)
    if device is None:
        sys.stderr.write(f"error: --platform {args.platform}: no CUDA device"
                         f" available (use --platform cpu for a host run)\n")
        return 2

    from bitmapperbs_tpu import constants as K
    from bitmapperbs_tpu.index.build import load_index
    from bitmapperbs_tpu.io.fastq import (FastqReader, Prefetcher, read_pairs,
                                          write_fastq)
    from bitmapperbs_tpu.io.sam import SamWriter
    from bitmapperbs_tpu.io.stats import MapStats
    from bitmapperbs_tpu.models.pool import make_finalize_pool
    from bitmapperbs_tpu_torch.index.device import upload_index
    from bitmapperbs_tpu_torch.models.host import map_batch, map_batch_pe

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
    cfg = make_config(args)
    idx = load_index(prefix)
    cfg = autotune_for_genome(cfg, args, int(sum(idx.genome.lengths)))

    bam = args.bam or args.output.endswith(".bam")
    if bam and args.output == "-":
        sys.stderr.write("error: --bam requires -o FILE\n")
        return 2
    # finalize workers are spawned (numpy only) before the device is touched
    pool = make_finalize_pool(idx, cfg, args.threads)
    dix = upload_index(idx, device)

    out_fh = sys.stdout if args.output == "-" else open(
        args.output, "wb" if bam else "w")
    stats = MapStats()
    unmapped, ambiguous = [], []
    t0 = time.time()
    cl = "bitmapperbs_tpu_torch " + " ".join(sys.argv[1:])
    if bam:
        from bitmapperbs_tpu.io.bam import BamWriter
        writer = BamWriter(out_fh, idx.genome.names, idx.genome.lengths,
                           rg=args.rg, cl=cl)
    else:
        writer = SamWriter(out_fh, idx.genome.names, idx.genome.lengths,
                           rg=args.rg, cl=cl)

    def emit(records, reads, qnames, quals):
        for rec, r, qn, q in zip(records, reads, qnames, quals):
            writer.write(rec)
            stats.add_record(rec)
            if args.unmapped_out and rec.flag & K.FLAG_UNMAPPED:
                unmapped.append((r, qn, q))
            if args.ambiguous_out and rec.mapq == 0 \
                    and not rec.flag & K.FLAG_UNMAPPED:
                ambiguous.append((r, qn, q))

    def run(c, codes, quals, qnames):
        return map_batch(idx, dix, c, codes, quals, qnames, stats=stats,
                         pool=pool)

    def run_pe(c, pairs, quals, qnames):
        return map_batch_pe(idx, dix, c, pairs, quals, qnames, stats=stats,
                            pool=pool)

    try:
        if args.pe:
            for b1, b2 in _closing_iter(Prefetcher(read_pairs(
                    args.seq1, args.seq2, cfg.batch_size, args.phred64))):
                prs = list(zip(b1.codes, b2.codes))
                quals = list(zip(b1.quals, b2.quals))
                recs = _map_grouped_pe(run_pe, cfg, error_rate, prs, quals,
                                       b1.qnames)
                # two records per pair: mate 1, mate 2
                emit(recs, [r for p in prs for r in p],
                     [q for q in b1.qnames for _ in (0, 1)],
                     [q for p in quals for q in p])
                out_fh.flush()
        else:
            # group `threads` reader batches per call so the finalize pool
            # has cross-batch work
            group_n = max(1, args.threads)
            gbuf: list = []

            def flush_group():
                if not gbuf:
                    return
                codes = [c for g in gbuf for c in g[0]]
                qnames = [c for g in gbuf for c in g[1]]
                quals = [c for g in gbuf for c in g[2]]
                gbuf.clear()
                emit(_map_grouped_se(run, cfg, error_rate, codes, quals,
                                     qnames), codes, qnames, quals)
                out_fh.flush()

            reader = FastqReader(args.seq, cfg.batch_size, args.phred64)
            for batch in _closing_iter(Prefetcher(reader)):
                gbuf.append((batch.codes, batch.qnames, batch.quals))
                if len(gbuf) >= group_n:
                    flush_group()
            flush_group()
    finally:
        if pool is not None:
            pool.terminate()
    if bam:
        writer.close()
    stats.report(wall_s=time.time() - t0)
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            f.write(stats.to_json() + "\n")
    if args.unmapped_out and unmapped:
        write_fastq(args.unmapped_out, *map(list, zip(*unmapped)))
    if args.ambiguous_out and ambiguous:
        write_fastq(args.ambiguous_out, *map(list, zip(*ambiguous)))
    if out_fh is not sys.stdout:
        out_fh.close()
    return 0


def main(argv=None) -> int:
    argv = _translate_legacy(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.cmd == "index":
        return cmd_index(args)
    if args.cmd == "search":
        return cmd_search(args)
    sys.stderr.write(f"error: `{args.cmd}` is not yet ported (ROADMAP.md); "
                     f"run it with python -m bitmapperbs_tpu.cli\n")
    return 2


if __name__ == "__main__":
    sys.exit(main())
