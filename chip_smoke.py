#!/usr/bin/env python3
"""Smoke run of the PyTorch port's single-end and paired-end search paths on
one CUDA card: on a 10 Mbp random genome with the default configuration,
and on a 100 Mbp repeat-structured genome with the Gbp-scale configuration.

    python3 chip_smoke.py            (from the repository root)

Phases, each printing `[smoke] ...` lines; any failure raises (exit != 0):
  1. card: name and power limit (nvidia-smi), torch / CUDA versions
  2. build: the native finalize library (make) and the CUDA kernels (one
     nvcc per source), all started together
  3. each kernel vs its plain PyTorch version at the main paths' shapes,
     torch.equal, median CUDA-event times: verify_fused_gather (fetching
     its own windows from the genome planes) and myers at 163,840 lanes
     (m = 96, e = 4); verify_fused_gather again at the 288 bucket of reads
     over 256 bp
     (before phase 12: 9 read words, 296 columns, 1,024 reads x flat cap
     lanes; the gathering entry's thread-group kernel, a lane of wd words
     on ceil(wd / K) threads of K words, one K per bucket
     (kernels.WIDE_WORDS): checked at buckets 512, 768 and 1,024 at 8,192
     lanes and at 288 at 43,008 on the 10 Mbp genome too (their SHARD
     instances in phase 11c); each bucket's words per thread, threads per
     lane, ptxas registers and resident warps per SM printed beside its
     time, a second timing from a CUDA graph of 20 launches, and every
     build's K timed at the bucket, held to the bucket's own; the 288
     bucket's lanes once more on planes tiled to ten times the genome,
     which spreads the same windows over 75 MB); rescue_scan (the Myers
     scan with its window fetch in front and its selection behind) at
     4,096 pairs (insert 0-500 -> 605 columns, 19 window words) and at a
     ragged 4,093, planted
     pairs without a window, zero and negative spans and mates cut down to
     a few bases (ties, seconds); its bound counts the columns the function
     needs (one scan per pair over its valid columns), with the columns its
     8 threads per pair run, warm-up included, beside it; checked again at
     buckets 288 and 1,024 (PEQ in shared memory), at the command line's
     default insert range (1,001 offsets), at ranges so wide that a
     block's shared memory makes the wrapper take 16 and 32 threads per
     pair, and past what 32 threads per pair fit (100,000 offsets at m 96,
     60,000 at m 1,024), where it runs in two passes that keep no byte per
     column: each pass timed inside the kernel beside its bound (m 96);
     gather_rows (before
     phase 12, on the 100 Mbp index's own tables, which do not fit the 50 MB
     L2): the k-mer table W = 2 at 4,096 x 2 x 5 lanes (the lookup the
     compact path launches; the record's headline), checkpoint rows W = 17
     at 327,680 lanes and at the flat buffer's 4,096 x cap lanes, SA samples
     W = 1 at a ragged count, genome planes W = 3 with [L, 5] indices;
     indices below 0 and past the end in every case.  Each timed call takes
     the next of 8 index sets, so rows come from device memory as on the
     mapping path.  fm_search, fm_extend and fm_locate (same place, same
     index) on the arguments that real batches hand them (captured from
     map_batch_device: 40,960 seed lanes and 172,032 flat lanes per
     4,096-read batch, 163,840 and 688,128 at 16,384) with edge lanes
     planted (empty and short slices, empty intervals, starts at 0,
     positions past the text, invalid lanes); the timed calls rotate through
     the batches.  Their bound counts the rows this data makes them fetch
     (the kernels report it) at 68 bytes each, with the same rows counted in
     whole 32-byte sectors beside it; and the latency floor: the longest
     chain of dependent loads of any lane times the card's dependent-load
     latency, measured by a one-thread probe on the checkpoint table with
     the L2 overwritten before each chain (and, for comparison, on a slice
     of it that stays in the L2).  Beside each kernel's time: the least time
     the card could take (`bound_ms`: bytes moved once over 3.35 TB/s, or
     integer operations over 16.75 T/s, whichever is larger; the INT32 rate
     is the data sheet's 67 TFLOP/s of FP32 FMA, halved for the FMA and
     halved again for the INT32 lanes; the operations are INT32-pipe
     instructions counted in the machine code that phase 2 dumps with
     cuobjdump) and, for gather_rows, the time of the one PyTorch call that
     computes it (index_select); no single PyTorch call computes any of the
     others.  fm_locate and verify_fused_gather also with a lane count on
     the card (n_lanes: the flat buffer's n_used / n_valid, lanes past it 0
     / INF), captured and planted.  The flat-buffer kernels (flat_expand,
     flat_dedup, scatter_back, select_se: csrc/flat.cu, no TPU kernel
     behind them) against their plain versions, every output torch.equal,
     on the arguments of phase 4's and phase 8's last batches, of the Gbp
     SE, PBAT SE, --sensitive SE and PE batches, and on seeded edge rows
     (flat_edge_args: every buffer cut of flat_cap_cuts, rows of more than
     Kc anchors, empty rows, ties); each timed (call, inside, CUDA graph,
     plain) at the three Gbp SE shapes beside its bytes bound
  4. SE main path: 10 Mbp two-contig genome, 4 x 16,384 reads through
     models.host.map_batch, eager (graphs=False), launches counted.  The
     last batch carries 1,024 low-complexity (pyrimidine-only, poly-T once
     converted) reads, as bisulfite libraries do; they overflow the flat
     buffer, so that batch takes the gdrop dense re-run.  SAM of the first
     128 and the last 8 reads equals the numpy oracle's; mapped fraction and
     recall against the simulator.  Then the same reads through map_batch
     with its CUDA graphs (models/graphs.py; the default on one card): the
     records equal the eager run's, and what the replays launched (replays
     x the launches each capture counted) is recorded per path
  5. SE forced gdrop: the first batch with locate_flat_cap=1 (dense fallback
     for every read) gives the same SAM as phase 4; its launches and peak
     device memory are reported apart from phase 4's
  6. SE CLI: `python -m bitmapperbs_tpu_torch search -t 4` (spawned
     finalize pool) in a subprocess gives the same records as phase 4
  7. SE throughput: map_batch_device reads/s over 8 distinct simulated
     batches (each synced by copying best_score to the host) and end-to-end
     map_batch reads/s over phase 4's 4 batches (every end-to-end rate
     here and below: median and range of three runs).  Then CUDA graphs
     against eager on phase 4's batches: all four dispatched through their
     graphs before the first is read, every output leaf torch.equal to the
     eager call's; the synced per-batch wall of each, 7 rounds in turns,
     median and range, the device idle share of each, each graph's capture
     time and pool bytes (the same for phases 11, 12 and 13)
  8. PE main path: 4 x 4,096 pairs (simulate_pairs, 90 bp, insert
     150-480; cfg insert 0-500 as bench.py) through models.host.map_batch_pe
     (eager, then through its CUDA graphs as in phase 4).
     The last batch ends with 256 pairs whose mate 2 carries one
     substitution in each of three of its five seeds, and 512
     low-complexity pairs (mate 1 pyrimidine-only, mate 2 purine-only) that
     take the gdrop dense re-run.  verify_fused_gather, rescue_scan and
     myers and pair_join must launch.  SAM of
     64 ordinary, 16 seed-killed and 8 low-complexity pairs equals the
     oracle's; proper-pair rate, recall, and how the last batch's pairs
     were decided (pair join / rescue / neither).  On a random genome a
     mate with <= e errors always has an exact seed (e + 1 seeds), so the
     pair join, not rescue, decides the seed-killed pairs; rescue decides
     where seeds are too frequent, hence
 8b. 64 pairs on a small genome with a tandem repeat, one mate inside it:
     rescue decides at least half, SAM equal to the oracle's
  9. PE forced gdrop: the first PE batch with locate_flat_cap=1 gives the
     same SAM, with its launches and peak device memory
 10. PE CLI: `search --pe -t 4` in a subprocess gives phase 8's records
 11. PE throughput: map_batch_pe_device reads/s (2 x pairs) over 8 distinct
     batches (synced by copying pair_sum) and end-to-end map_batch_pe
     reads/s over phase 8's batches
 11b. CLI features and wide inserts, on the same index: `search` SE (SAM)
     and PE (BAM, -t 2) SIGKILLed once `<out>.cursor` has advanced, then
     `--resume`: records equal phase 6's and phase 10's, the cursor gone;
     the resumed PE run (one batch) with `--profile DIR`: its Chrome trace
     names the port's kernels (verify_fused_gather, fm_search, fm_locate,
     rescue_scan); two
     processes on the one card with --dist-hosts 2 (gloo on 127.0.0.1),
     byte ranges then record striding: the shards together are phase 6's
     records, the global counters phase 6's stats; then PE at insert
     0-100,000 through map_batch_pe (the rescue kernel in two passes): the
     last PE batch, SAM of a sample equal to the oracle's, the same through
     its CUDA graph (both passes inside it) and phase 8's first three
     batches at that range against eager, leaf by leaf; each pass of the
     rescue kernel timed inside on the arguments that batch's device call
     hands it, beside its bound for the columns those pairs need; and phase
     8b's repeat pairs, rescue deciding at least half, SAM equal to the
     oracle's
 11c. Several cards in one process, the card standing for each of them
     (parallel/shard.make_cli_mappers; a device may repeat in a mesh).
     First, as phase 3 additions on this index: gather_rows_shard (the
     row-range gather of the sharded index) vs its plain version on each
     shard of a 2-shard upload, at the lanes a data slice of 8,192 reads
     hands it (genome planes W = 3 at [flat lanes, 5], the dense re-run's
     window gather and the record's headline; checkpoint rows, SA
     samples), lanes on both sides of every shard boundary, in the
     padding, below 0 and past the end, the partial rows summed equal to
     the whole table's; then the SHARD instances of the fused kernels
     (each row read from the shard that holds it, a zero row past the
     table) vs their plain versions and vs the whole-table instance, on
     2- and 3-shard uploads: fm_search / fm_extend / fm_locate on the
     arguments a data slice of phase 4's last batch hands them (seed
     extension on), edge lanes and rows past the table planted;
     verify_fused_gather at m 96 (163,840 lanes) and m 288 (10,240;
     the 512, 768 and 1,024 buckets at 1,024 lanes held to both, not
     timed); rescue_scan in one pass (insert 0-500) and in two (100,001
     offsets), each timed inside beside the whole-table instance and its
     bound (the FM and verify rows also from a CUDA graph).
     Then phase 4's reads and phase 8's pairs on [cuda:0] x 2 (data
     parallel), and phase 4's and phase 8's last batches and phase 11b's
     wide-insert batch on [cuda:0] x 4 with --shard-index 2 (2 data slices,
     each index split over 2 shards; their low-complexity reads take the
     dense re-run, their seed-killed mates rescue): records equal phase
     4's, phase 8's and phase 11b's, the wide batch's peak device memory
     beside one card's; phase 8b's tandem-repeat pairs on the sharded
     mesh: SAM equal to the oracle's, rescue deciding all 64.  The sharded
     paths launch what one card launches (fm_search, fm_locate,
     verify_fused_gather, and PE rescue_scan), gather_rows_shard and myers
     only in the dense re-run; each
     path's synced wall, the last batches' per-batch walls on one card,
     data parallel and sharded (taking turns, 7 rounds), and each shard's
     table bytes are printed
 12. SE, Gbp-scale configuration (what cli.autotune_for_genome sets above
     512 Mbp: seed extension 20 / occ 4, 128 candidates; batch 4,096) on a
     100 Mbp two-contig genome with planted human-profile repeats
     (utils.simulate.repeat_genome_fasta), index at sa_rate 4: 4 x 4,096
     reads through map_batch; the last batch ends with 2,048 reads from
     inside mid-copy satellite arrays, which overflow the flat buffer and
     take the dense re-run at 128 candidates; then 1,024 reads of 280 bp in
     a 288 bucket, whose 9 plane words take the gathering verify's
     thread-group kernel (one launch, no window_planes);
     both again through their CUDA graphs, records equal.
     SAM
     of a sample equals the oracle's; recall, mapped share, overflow and
     gdrop counts; one batch
     with flat_chunks = 2 gives the same tensors; device reads/s at 4,096
     and at 16,384 per batch; end to end; the per-stage table (a device
     sync at each stage boundary); device idle share (torch.profiler's
     kernel time against unprofiled walls taken before it); peak memory
 13. PE, Gbp-scale configuration: 2 x 4,096 pairs through map_batch_pe, SAM
     of a sample equal to the oracle's, proper-pair rate, how pairs were
     decided (pair join / rescue / neither), device and end-to-end rates;
     one rescue_scan and one pair_join launch per map_batch_pe_device
     call; the records again through the CUDA graphs; graphs against eager
     on phase 12's and these batches (a third PE batch: the first with its
     mates swapped); then the pair join kernel (csrc/pair.cu, no TPU
     kernel behind it: the reference's plain jnp under jit) against its
     plain version, all nine outputs torch.equal, on the arguments this
     batch's device call hands it (directional, Kc 128), the batch mapped
     PBAT (4 frame pairs) and at Kc 256, and on seeded grids of 4,096 pairs
     with edge rows (no ok cell, empty sides, duplicate anchors, inserts at
     the range's ends, anchors near 0 and L, the second-best's distance
     rule): call, inside, CUDA graph, plain and bytes bound, and the time
     of the arguments emptied and with one pair of Kc x Kc cells; the PE
     device call's peak device memory and largest tensor with the plain
     join and with the kernel (which makes no [B, Kc, Kc] tensor); the
     synced stage tables of the 280 bp batch and of the PE batches
     (candidate stages, pair join, select, rescue; the pair join row with
     the plain join too), the PE path's device kernels, idle share and
     peak memory
 13c. The Gbp --pbat autotune (flat cap 192 in 3 chunks): 4 x 4,096 reads
     of all four strands and 4 x 4,096 pairs (every other pair's mates
     swapped) through map_batch / map_batch_pe eager, launches counted, SAM
     of a sample equal to the oracle's; then through their CUDA graphs
     (records equal), the batches against eager leaf by leaf, walls eager
     and graph, idle share, kernels per batch, capture and pool
 13d. The same for --sensitive at Gbp (256 candidates in 2 chunks) on
     phase 12's first 4 x 4,096 reads
 13b. Trimmed reads (150 bp cut by the length model of TRIM_KEEPS, in a
     160 bucket), 4 x 4,096 reads and 4 x 4,096 pairs of the Gbp config
     through map_batch / map_batch_pe with their graphs and eager, records
     equal: the graph keys they made (captures; nothing is evicted), their
     replays, the synced per-batch walls eager and graph, each capture's
     seconds and pool; and, from lengths only, the keys and the share of
     reads in graphed (full) batches that the CLI's chunks of 4,096 give
     1,048,576 reads or pairs at -e 4 and at -e 0.04, for both models
 14. CLI on the saved 100 Mbp artifact with `--seed-ext 20
     --max-candidates 128` gives phase 12's records
Every graphed configuration's eager device call runs once under
torch.cuda.set_sync_debug_mode("error") (no_host_sync): no host sync is left
in it.  Launch counts are set to 0 just before each main path (phases 4, 8,
11b's wide-insert batch, 11c's four paths, 12, 13, 13c, 13d), which run
eager, and read just after it; beside them, for each graphed run of those paths, its
graphs' replays times the launches each capture counted (computed, never
0; the run's eager tail batches and gdrop re-runs are not in it).  The
kernels' record gives, per kernel, the launches of the slices' main paths
(phase 11b's wide-insert batch, 11c's data-parallel SE and PE and sharded
SE and PE paths, phase 12's 96 bp batches, its 280 bp batch, counted on
its own, and phase 13) with every path's beside them.
Every TPU kernel of the reference has at least one entry point that those
paths launch, and every entry point launches on one of them.  pair_join and
the four flat-buffer entries stand for no TPU kernel
(NO_TPU_KERNEL_ENTRIES); pair_join launches on the PE paths, the
flat-buffer entries once per candidate stage (select_se once per SE and
twice per PE device call, and in every dense re-run).
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

GENOME_CONTIGS = (5_000_000, 5_000_000)
BATCH = 16_384
N_MAIN_BATCHES = 4
N_LOWCX = 1_024                    # low-complexity reads ending phase 4
N_TIMED_BATCHES = 8
BUCKET, READ_LEN, E = 96, 90, 4
KERNEL_LANES = BATCH * 10          # CAP: 16,384 reads x flat cap 10 at 10 Mbp
N_ORACLE, N_ORACLE_LOWCX = 128, 8
REPS = 20
CLI_THREADS = 4                    # finalize worker processes in phase 6

PE_PAIRS = 4_096                   # pairs per PE batch (bench.py:149)
N_PE_MAIN_BATCHES = 4
N_PE_RESCUE, N_PE_LOWCX = 256, 512  # groups ending the PE main path
N_PE_TIMED_BATCHES = 8
MIN_INSERT, MAX_INSERT = 0, 500    # bench.py:150-151
SCAN_LANES = (PE_PAIRS, PE_PAIRS - 3)  # one lane per pair; a ragged count
# widths no main path here reaches, checked on the card all the same: the
# gathering verify's 16-, 24- and 32-word kernels (bucket, read length,
# lanes), and its 288 bucket at the Gbp phase's lane count on the 10 Mbp
# genome; and
# the rescue scan (bucket, insert range, pairs, threads per pair) with its
# PEQ in shared memory, at the command line's default insert range, and at
# ranges whose bytes per output column make a block hold fewer pairs
WIDE_VERIFY_SHAPES = ((512, 500, 8_192), (768, 750, 8_192),
                      (1_024, 1_000, 8_192), (288, 280, 43_008))
# the SHARD instances of the wide gathering verify past the 288 bucket's
# (bucket, lanes), held to plain and to the whole-table instance in phase
# 11c beside the timed m 96 / 288 rows, on 2 and 3 shards
WIDE_SHARD_SHAPES = ((512, 1_024), (768, 1_024), (1_024, 1_024))
# copies of the 10 Mbp genome planes laid end to end for phase 3's span
# check: the 288 bucket's windows spread over the Gbp index's 75 MB
SPAN_TILES = 10
WIDE_RESCUE_SHAPES = ((288, 301, 1_024, 8), (96, 1_001, 1_024, 8),
                      (1_024, 1_001, 512, 8), (96, 20_000, 128, 16),
                      (288, 13_000, 64, 16), (96, 40_000, 64, 32),
                      # past what 32 threads per pair fit: the two passes
                      (96, 100_000, 64, 32), (1_024, 60_000, 32, 32))
WIDE_PE_MAX_INSERT = 100_000       # phase 11b: a PE batch in the two passes
PLAIN_SCAN_REPS = 5                # the plain scan is ~600 columns of ops
KILL_POS = (9, 27, 63)             # in seeds 0, 1 and 3 of a 90 bp read
N_PE_ORACLE, N_PE_ORACLE_RESCUE, N_PE_ORACLE_LOWCX = 64, 16, 8
N_REPEAT_PAIRS = 64                # phase 8b: one mate inside a repeat

GBP_CONTIGS = (50_000_000, 50_000_000)   # planted-repeat genome, phase 12-14
GBP_GENOME_BP = 3_080_000_000      # the size autotune_for_genome is asked for
GBP_BATCH = 4_096
N_GBP_MAIN_BATCHES = 4
N_GBP_SAT = 2_048                  # satellite-array reads ending phase 12
SAT_PERIOD, SAT_WINDOW = 171, 512  # plant_repeats' alpha-satellite-like unit
SAT_COPIES = (30, 128)             # arrays whose seeds stay under max_seed_occ
GBP_BIG_BATCH, N_GBP_BIG_BATCHES = 16_384, 4
N_GBP_ORACLE, N_GBP_ORACLE_SAT = 64, 8
N_GBP_PE_BATCHES, N_GBP_PE_ORACLE = 2, 48
N_GBP_VARIANT_BATCHES = 4          # phases 13c / 13d: 4 x 4,096 reads, pairs
GATHER_LANES = 2 * 16_384 * 2 * 5  # 2 endpoints x reads x frames x seeds
GATHER_SETS = 8                    # index sets rotated through a timing
LONG_BUCKET, LONG_READ_LEN, N_LONG = 288, 280, 1_024   # ending phase 12
N_LONG_ORACLE = 8
PLAIN_LONG_REPS = 5                # the plain verify at 296 columns
FM_KERNELS = ("fm_search", "fm_extend", "fm_locate")
PLAIN_FM_REPS = 5                  # the lockstep loops are tens of ms
E2E_REPS = 3                       # runs of each end-to-end timing
MESH_WALL_ROUNDS = 7               # phase 11c: rounds of the per-batch walls
GRAPH_ROUNDS = 7                   # eager / CUDA-graph walls taken in turns
# phase 13b, trimmed reads.  The length model is stated, not taken from a
# dataset: a read of TRIM_READ_LEN bp keeps its length with probability
# `keep`, else its 3' end is cut to a length uniform in [TRIM_MIN,
# TRIM_READ_LEN) (adapter read-through of short fragments, quality
# trimming); TRIM_MIN is Trim Galore's default --length.
TRIM_READ_LEN, TRIM_BUCKET, TRIM_MIN = 150, 160, 20
TRIM_KEEPS = (0.8, 0.98)           # the card maps the first
N_TRIM_BATCHES = 4                 # SE and PE batches mapped on the card
N_TRIM_COUNT = 1_048_576           # reads (pairs) of the length-only count
TRIM_RATE = 0.04                   # an -e error rate: budgets 1-6 by length
PLAIN_JOIN_REPS = 5                # the plain pair join builds 537 MB grids
WIDE_JOIN_KC = 256                 # the pair join at 256 candidates a frame
CHASE_STEPS = 20_000               # dependent loads of the latency probe
L2_EVICT_BYTES = 400_000_000       # written to push a table out of the 50 MB L2
L2_RESIDENT_BYTES = 8_000_000      # a slice of a table that stays in the L2

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT32_OPS_PER_S = 67e12 / 4        # FP32 FMA rate / 2 (FMA) / 2 (INT32 lanes)
# The operation counts of the bounds are read from the machine code of the
# libraries this run built (cuobjdump -sass, kept as <library>.sass beside
# each): per kernel, the instructions of the INT32 pipe in its innermost loop
# (one Myers column, one FM step of one thread) and outside its loops (run at
# most once per thread).  Left out: IMAD (the FMA pipe), the uniform data
# path (U*), loads, stores, shuffles, votes and branches.  The verify
# kernels are read at their BUCKET // 32 = 3-word build; another word count
# scales both numbers in proportion.
INT32_PIPE = frozenset(
    "IADD3 LOP3 PLOP3 SHF ISETP SEL LEA IMNMX VIMNMX VIADD VIADDMNMX PRMT "
    "IABS POPC FLO BREV MOV SGXT BMSK".split())
SASS_KERNELS = {        # kernel -> (library, what its mangled name contains)
    "verify_fused_gather": ("verify", "verify_fused_gather_kernelILi3ELb0E"),
    "myers": ("verify", "12myers_kernelILi3E"),
    "rescue_scan": ("verify", "rescue_scan_kernelILi3ELb0ELi0ELb0E"),
    "fm_search": ("fm", "fm_search_kernelILb0E"),
    "fm_extend": ("fm", "fm_extend_kernelILb0E"),
    "fm_locate": ("fm", "fm_locate_kernelILb0E"),
}
# the two passes of rescue_scan's mode for insert ranges past the bytes'
# limit, counted apart from its one-pass kernel
SASS_PASSES = {
    "rescue_scan pass 1": ("verify", "rescue_scan_kernelILi3ELb0ELi1ELb0E"),
    "rescue_scan pass 2": ("verify", "rescue_scan_kernelILi3ELb0ELi2ELb0E"),
}
# the SHARD instances, which read a sharded index (csrc/shards.cuh; their
# last template argument true), counted apart from the whole-table ones
SASS_SHARD = {
    "verify_fused_gather shard": ("verify",
                                  "verify_fused_gather_kernelILi3ELb1E"),
    "rescue_scan shard": ("verify", "rescue_scan_kernelILi3ELb0ELi0ELb1E"),
    "rescue_scan pass 1 shard": ("verify",
                                 "rescue_scan_kernelILi3ELb0ELi1ELb1E"),
    "rescue_scan pass 2 shard": ("verify",
                                 "rescue_scan_kernelILi3ELb0ELi2ELb1E"),
    "fm_search shard": ("fm", "fm_search_kernelILb1E"),
    "fm_extend shard": ("fm", "fm_extend_kernelILb1E"),
    "fm_locate shard": ("fm", "fm_locate_kernelILb1E"),
}
SASS_OPS: dict = {}     # kernel -> {"loop": n, "once": n}, set by build_native
# (K words per thread, SHARD) -> {"registers", "spill", "smem",
# "resident_warps", "local_in_loops"} of each build of the wide gathering
# verify, set by build_native
WIDE_BUILDS: dict = {}
# the H100's register file per SM sub-partition, shared memory per SM and
# what each block reserves of it (CUDA occupancy rules, sm_90)
REGS_PER_SMSP, SMEM_PER_SM, SMEM_PER_BLOCK = 16_384, 233_472, 1_024
FM_THREADS_PER_ROW = 2  # csrc/fm.cu kTpr
CP_ROW_BYTES = 68
# 32-byte sectors under the words a kernel reads of a 68-byte row at a
# 68-byte stride (a row starts 0, 4, .. 28 bytes into a sector, each equally
# often): all 17 words span 3 sectors wherever the row starts; the 12 count
# and BWT-plane words of search and extend span 2 in five of the eight
# cases and 3 in the others
CP_ROW_SECTORS = {"fm_search": 2.375, "fm_extend": 2.375, "fm_locate": 3}

KERNEL_SOURCES = {
    "myers": ("bitmapperbs_tpu_torch/csrc/verify.cu",
              "bitmapperbs_tpu/ops/pallas_kernels.py:29"),
    "rescue_scan": ("bitmapperbs_tpu_torch/csrc/verify.cu",
                    "bitmapperbs_tpu/ops/pallas_kernels.py:119 "
                    "(myers_scan_pallas) with the selection of "
                    "bitmapperbs_tpu/models/paired.py:220-238"),
    "gather_rows": ("bitmapperbs_tpu_torch/csrc/gather.cu",
                    "scripts/pallas_gather_proto.py:28"),
    "gather_rows_shard": ("bitmapperbs_tpu_torch/csrc/gather.cu",
                          "scripts/pallas_gather_proto.py:28 (with the "
                          "sharded fetch of bitmapperbs_tpu/ops/fm.py:46-69)"),
    "verify_fused_gather": ("bitmapperbs_tpu_torch/csrc/verify.cu",
                            "bitmapperbs_tpu/ops/pallas_kernels.py:212"),
    "fm_search": ("bitmapperbs_tpu_torch/csrc/fm.cu",
                  "scripts/pallas_gather_proto.py:28"),
    "fm_extend": ("bitmapperbs_tpu_torch/csrc/fm.cu",
                  "scripts/pallas_gather_proto.py:28"),
    "fm_locate": ("bitmapperbs_tpu_torch/csrc/fm.cu",
                  "scripts/pallas_gather_proto.py:28"),
    "pair_join": ("bitmapperbs_tpu_torch/csrc/pair.cu",
                  "bitmapperbs_tpu/models/paired.py:80-145 (plain jnp "
                  "under jax.jit: no Pallas kernel)"),
    "flat_expand": ("bitmapperbs_tpu_torch/csrc/flat.cu",
                    "bitmapperbs_tpu/models/aligner.py:111-120 and 366-406 "
                    "(plain jnp under jax.jit: no Pallas kernel)"),
    "flat_dedup": ("bitmapperbs_tpu_torch/csrc/flat.cu",
                   "bitmapperbs_tpu/models/aligner.py:421-437 (plain jnp "
                   "under jax.jit: no Pallas kernel)"),
    "scatter_back": ("bitmapperbs_tpu_torch/csrc/flat.cu",
                     "bitmapperbs_tpu/models/aligner.py:490-515 (plain jnp "
                     "under jax.jit: no Pallas kernel)"),
    "select_se": ("bitmapperbs_tpu_torch/csrc/flat.cu",
                  "bitmapperbs_tpu/models/aligner.py:520-548 (plain jnp "
                  "under jax.jit: no Pallas kernel)"),
}
# the entries with no TPU kernel behind them: work that the reference
# writes as plain jnp and leaves to XLA under jax.jit, which the port runs
# as a kernel of its own; each must launch on a main path too
NO_TPU_KERNEL_ENTRIES = ("pair_join", "flat_expand", "flat_dedup",
                         "scatter_back", "select_se")
FLAT_KERNELS = NO_TPU_KERNEL_ENTRIES[1:]
# every TPU kernel (each function of the reference that reaches
# pl.pallas_call) and the port's entry points that stand for it: at least
# one entry of each must launch on a main path
TPU_KERNEL_ENTRIES = {
    "verify_fused_pallas": ("verify_fused_gather",),
    "myers_pallas": ("myers",),
    "myers_scan_pallas": ("rescue_scan",),
    "make_pallas_gather.gather": ("gather_rows", "gather_rows_shard",
                                  "fm_search", "fm_extend", "fm_locate"),
}


# per graphed main path and kernel: each graph's replays times the launches
# its capture counted, summed (a product, not a count: a replay counts
# nothing in Python; the path's eager tail batches and gdrop re-runs are
# not in it), set by graph_path
GRAPH_PATHS: dict = {}
# (cfg, PE) of every device call no_host_sync has run under
# torch.cuda.set_sync_debug_mode("error")
SYNC_CHECKED: set = set()
# kernel -> record of the flat-buffer kernels, filled by phase_flat_kernels
FLAT_RECORD: dict = {}


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, reps: int = REPS) -> float:
    """Median time of fn() in ms, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_rates(fn, n_reads: int, reps: int = E2E_REPS):
    """reads/s of fn() (n_reads per call) on the host's clock, reps runs:
    (median, lowest, highest, the last call's result).  One run of a few
    batches moves with whatever else the host is doing, so the range is
    reported beside the median."""
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        rates.append(n_reads / (time.perf_counter() - t0))
    return statistics.median(rates), min(rates), max(rates), out


def device_ms(fn, kernel: str = "", reps: int = 10, tries: int = 3):
    """Device time in ms per call of fn() spent in the CUDA kernels whose
    name contains `kernel` (all of fn's kernels by default), from
    torch.profiler's kernel rows over reps calls: what the card spends
    inside the kernels, without the host's launch cost.  The profiler may
    lose events, so the total is divided by the calls it saw (the count of
    the least frequent kernel, which runs once per call), not by reps, and
    a pass that saw no kernel is repeated.  None if no pass saw one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if kernel in e.key
                and e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in rows)
        seen = min((e.count for e in rows), default=0)
        if total and seen:
            return total / seen / 1e3
    return None


def graph_ms(fn, calls: int = 20, replays: int = 7):
    """Device ms per call of fn() from CUDA events around a CUDA graph of
    `calls` calls (the median of `replays` replays): the launches back to
    back with no host in between, a second reading beside device_ms's
    profiler rows."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def clocked_graph_ms(fn, replays: int = 200) -> tuple:
    """graph_ms over `replays` replays (about a second for a 0.2 ms call)
    and the median SM clock in MHz that nvidia-smi read every 100 ms
    meanwhile (None if it read none): whether the card ran at the same
    clock where two timings of one kernel part."""
    reader = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        ms = graph_ms(fn, replays=replays)
    finally:
        reader.terminate()
        text, _ = reader.communicate(timeout=60)
    mhz = [int(x) for x in text.split() if x.isdigit()]
    return ms, statistics.median(mhz) if mhz else None


def wide_build(words: int, shard: bool = False):
    """The wide gathering verify's build that takes a bucket of `words` read
    words (None at 1..8 words: the narrow kernel): its words per thread, the
    threads a lane runs on, its ptxas record."""
    from bitmapperbs_tpu_torch.ops import kernels

    if words <= 8:
        return None
    k = kernels.wide_words(words)
    return {"words": k, "threads": -(-words // k), **WIDE_BUILDS[k, shard]}


def resident_warps(regs: int, smem: int, threads: int = 128) -> int:
    """Warps per SM that blocks of `threads` threads with these registers
    per thread and bytes of static shared memory per block leave room for
    (registers allocated per warp in 256s; 64 warps, 32 blocks per SM)."""
    wpb = threads // 32
    warp_regs = -(-regs * 32 // 256) * 256
    blocks = min(4 * (REGS_PER_SMSP // warp_regs) // wpb,
                 SMEM_PER_SM // (smem + SMEM_PER_BLOCK), 64 // wpb, 32)
    return blocks * wpb


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes moved once over the
    memory rate, or integer operations over the INT32 rate."""
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by, op),
            "bound_by": "bytes" if by >= op else "operations"}


def sass_code(sass: str, function: str) -> tuple[list, list]:
    """The kernel whose mangled name contains `function` in cuobjdump's
    listing: its instructions (address, opcode, branch target or None) and
    its loops (the spans of its backward branches, first branch first)."""
    body = [part for part in sass.split("Function : ")[1:]
            if function in part.split("\n", 1)[0]]
    assert len(body) == 1, (function, len(body))
    code = []                           # (address, opcode, branch target)
    for m in re.finditer(r"^\s+/\*([0-9a-f]{4,6})\*/\s+([^;]+);", body[0],
                         re.M):
        text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
        to = re.search(r"^BRA\b.*\b0x([0-9a-f]+)$", text)
        code.append((int(m.group(1), 16), text.split()[0].split(".")[0],
                     int(to.group(1), 16) if to else None))
    loops = [(to, at) for at, _, to in code if to is not None and to < at]
    assert loops, f"{function}: no loop in the machine code"
    return code, loops


def sass_local_in_loops(sass: str, function: str) -> int:
    """Local-memory loads and stores (LDL / STL: spills) inside any loop of
    the kernel whose mangled name contains `function`."""
    code, loops = sass_code(sass, function)
    return sum(op in ("LDL", "STL") and any(lo <= at <= hi
                                            for lo, hi in loops)
               for at, op, _ in code)


def sass_int32_ops(sass: str, function: str) -> dict:
    """INT32-pipe instructions of the kernel whose mangled name contains
    `function`, from cuobjdump's listing: {"loop": in its innermost loop (the
    span of the first backward branch), "once": outside every loop}."""
    code, loops = sass_code(sass, function)
    lo, hi = loops[0]
    first, last = min(a for a, _ in loops), max(b for _, b in loops)
    out = {"loop": sum(op in INT32_PIPE for at, op, _ in code
                       if lo <= at <= hi),
           "once": sum(op in INT32_PIPE for at, op, _ in code
                       if not first <= at <= last)}
    assert out["loop"] > 0, (function, out)
    return out


def verify_ops(kernel: str, lanes: int, myers_lanes: int, ncols: int,
               words: int) -> float:
    """INT32-pipe operations of a verify kernel: its once-per-lane part on
    every lane, its column loop on the lanes that run Myers."""
    c = SASS_OPS[kernel]
    return (lanes * c["once"] + myers_lanes * ncols * c["loop"]) \
        * words / (BUCKET // 32)


def build_native() -> None:
    """Builds libsais.so and the CUDA kernels, dumps their machine code and
    reads the instruction counts of the bounds from it."""
    from bitmapperbs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    native = os.path.join(ROOT, "bitmapperbs_tpu_torch", "index",
                          "sais_native")
    make = subprocess.Popen(["make", "-C", native, "libsais.so"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    paths = kernels.build()            # one nvcc per source, side by side
    t1 = time.perf_counter()
    out, _ = make.communicate(timeout=600)
    if make.returncode != 0:
        raise RuntimeError(f"make libsais.so failed:\n{out[-4000:]}")
    log(f"build: CUDA kernels {t1 - t0:.2f} s "
        f"({', '.join(os.path.basename(p) for p in paths.values())}), "
        f"libsais.so beside them, all done after "
        f"{time.perf_counter() - t0:.2f} s")
    # ptxas -v: one "Compiling entry function '<name>'" per kernel, then its
    # spill line and its register line
    for so in paths.values():
        name = spill = None
        with open(so + ".log") as f:
            for ln in f:
                if "Compiling entry function" in ln:
                    name = ln.split("'")[1]
                elif "spill stores" in ln:
                    spill = ", ".join(x.strip() for x in ln.split(","))
                elif "Used" in ln and "registers" in ln and name:
                    regs = ln.split("Used")[1].split(",")[0].strip()
                    log(f"ptxas: {name}: {regs}, {spill}")
                    # verify_fused_gather_wide_kernel<K, SHARD>
                    wide = re.search(r"wide_kernelILi(\d+)ELb([01])E", name)
                    if wide:
                        smem = re.search(r"(\d+) bytes smem", ln)
                        smem = int(smem[1]) if smem else 0
                        WIDE_BUILDS[int(wide[1]), wide[2] == "1"] = {
                            "function": wide[0],
                            "registers": int(regs.split()[0]),
                            "spill": spill, "smem": smem,
                            "resident_warps": resident_warps(
                                int(regs.split()[0]), smem)}
                    name = None
    assert sorted(WIDE_BUILDS) == sorted(
        (k, shard) for k in set(kernels.WIDE_WORDS.values())
        for shard in (False, True)), WIDE_BUILDS
    # the machine code beside each library (<library>.sass), and from it the
    # instruction counts of the operation bounds
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = {}
    for lib, so in paths.items():
        sass[lib] = subprocess.run([cuobjdump, "-sass", so],
                                   capture_output=True, text=True, check=True,
                                   timeout=300).stdout
        with open(so + ".sass", "w") as f:
            f.write(sass[lib])
    for name, (lib, function) in {**SASS_KERNELS, **SASS_PASSES,
                                  **SASS_SHARD}.items():
        SASS_OPS[name] = sass_int32_ops(sass[lib], function)
        log(f"sass: {name} ({function}): {SASS_OPS[name]['loop']} INT32-pipe "
            f"instructions in its innermost loop, {SASS_OPS[name]['once']} "
            f"outside its loops")
    for b in WIDE_BUILDS.values():
        b["local_in_loops"] = sass_local_in_loops(sass["verify"],
                                                  b["function"])
    log("wide gathering verify (a lane of wd words on ceil(wd / K) "
        "threads): " + "; ".join(
            f"K {k}{' SHARD' if shard else ''}: {b['registers']} registers, "
            f"{b['smem']} bytes of shared memory, {b['resident_warps']} "
            f"resident warps per SM, {b['spill']}, {b['local_in_loops']} "
            f"local-memory instructions in its loops"
            for (k, shard), b in sorted(WIDE_BUILDS.items())))


def kernel_inputs(idx, dix, n: int, seed: int, span: int = 0,
                  m: int = BUCKET, read_len: int = READ_LEN):
    """Candidate lanes at the main path's widths (bucket m, reads of
    read_len): reads cut from either
    genome orientation with bisulfite conversion, per-lane substitution
    rates and indel-like offsets (ham <= e and ham > e both occur), N codes,
    reads shorter than the bucket, window starts that wrap below 0 and
    windows that run past the genome end.  span > 0 (the rescue scan):
    windows cover m + 2e + span columns and each read starts up to
    span - 1 columns further in.  The last item is what the gathering
    verify takes instead of planes: per lane the orientation, the window
    start, a row of the read-plane table and the read length."""
    import numpy as np
    import torch

    from bitmapperbs_tpu_torch import constants as K
    from bitmapperbs_tpu_torch.ops import verify
    from bitmapperbs_tpu_torch.ops.u32 import bnot, wrap

    rng = np.random.default_rng(seed)
    L = idx.genome.length
    ref = np.stack([idx.genome.codes, idx.genome.rc_codes()])
    orient = rng.integers(0, 2, n)
    anchor = rng.integers(0, L - m, n)
    k = n // 50
    anchor[:k] = rng.integers(0, E, k)                     # anchor - e < 0
    anchor[k:2 * k] = L - rng.integers(1, m, k)            # past the end
    lens = np.where(rng.random(n) < 0.2, rng.integers(m // 2, m + 1, n),
                    read_len)
    shift = np.where(rng.random(n) < 0.3, rng.integers(-2, 3, n), 0)
    if span:
        shift = shift + rng.integers(0, span, n)
    pos = anchor[:, None] + shift[:, None] + np.arange(m)
    inside = (pos >= 0) & (pos < L)
    reads = ref[orient[:, None], np.clip(pos, 0, L - 1)]
    reads[~inside] = K.N_CODE
    conv = (reads == K.C) & (rng.random(reads.shape) < 0.7)
    reads[conv] = K.T
    rate = rng.choice([0.0, 0.01, 0.05], n)[:, None]
    sub = rng.random(reads.shape) < rate
    reads[sub] = (reads[sub] + 1) % 4
    reads[rng.random(reads.shape) < 0.005] = K.N_CODE
    reads[np.arange(m)[None, :] >= lens[:, None]] = K.N_CODE

    dev = dix.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rp = verify.pack_codes(t(reads.astype(np.uint8)))
    lm = verify.length_mask(t(lens), m)
    ncols = m + 2 * E + span
    wide = verify.window_planes(dix.g_planes, t(orient),
                                wrap(t(anchor) - E), -(-ncols // 32), L,
                                dix.g_words)
    peq, pad = verify.peq_from_planes(*rp, bnot(lm))
    lanes = {"orient": t(orient), "start": wrap(t(anchor) - E),
             "read_tab": torch.cat(rp, dim=-1).contiguous(),
             "row": torch.arange(n, dtype=torch.int64, device=dev),
             "lens": t(lens)}
    return wide, rp, lm, peq, pad, lanes


def phase_kernels(idx, dix, names, n_lanes: int = KERNEL_LANES,
                  m: int = BUCKET, read_len: int = READ_LEN,
                  plain_reps: int = REPS) -> dict:
    """The verify kernels in `names` vs their plain versions on n_lanes
    candidate lanes of bucket m."""
    import torch

    from bitmapperbs_tpu_torch.ops import kernels, verify

    ncols = m + 2 * E
    Wd, Ww = m // 32, -(-ncols // 32)
    wide, rp, lm, peq, pad, lanes = kernel_inputs(idx, dix, n_lanes, seed=7,
                                                  m=m, read_len=read_len)
    g_args = (dix.g_planes, lanes["orient"], lanes["start"],
              lanes["read_tab"], lanes["row"], lanes["lens"], dix.genome_len,
              dix.g_words, m, ncols, E)
    # lanes whose Hamming count does not decide them run the Myers loop
    ham = verify.hamming(verify.shift_planes(wide, E, Wd), rp, lm)
    n_myers = int((ham > E).sum())
    L = n_lanes
    bounds = {
        "myers": bound(L * 4 * (3 * Ww + 5 * Wd + 1),
                       verify_ops("myers", L, L, ncols, Wd)),
        # Ww + 1 plane rows of 12 bytes, four int64 lane inputs, one int64
        # read-plane row, one int32 out
        "verify_fused_gather": bound(
            L * (12 * (Ww + 1) + 4 * 8 + 8 * 3 * Wd + 4),
            verify_ops("verify_fused_gather", L, n_myers, ncols, Wd)),
    }
    cases = {
        "myers": (lambda: kernels.myers(wide, peq, pad, m, ncols),
                  lambda: kernels.myers_ref(wide, peq, pad, m, ncols)),
        "verify_fused_gather": (
            lambda: kernels.verify_fused_gather(*g_args),
            lambda: kernels.verify_fused_gather_ref(*g_args)),
    }
    out = {}
    for name in names:
        kern, plain = cases[name]
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape == (L,), (got.shape, want.shape)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name} (m {m}): kernel != plain on "
                                 f"{int((got != want).sum())} lanes")
        counts = ()
        if name == "verify_fused_gather":
            # a lane count as the compact path hands it (n_valid): the
            # lanes at or past it INF, loaded by no thread
            counts = (0, L // 3, L, L + 7)
            for c in counts:
                t = torch.tensor([c], dtype=torch.int64, device=dix.device)
                g = kernels.verify_fused_gather(*g_args, n_lanes=t)
                w = kernels.verify_fused_gather_ref(*g_args, n_lanes=t)
                torch.cuda.synchronize()
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"{name} (m {m}) with a lane count of {c}: kernel "
                        f"!= plain on {int((g != w).sum())} lanes")
        ms, plain_ms = median_ms(kern), median_ms(plain, reps=plain_reps)
        # the gathering entry has two kernels (registers / shared memory)
        inside = device_ms(kern, name if name == "verify_fused_gather"
                           else name + "_kernel")
        if name == "verify_fused_gather":
            frac = float((want <= E).float().mean())
            extra = f", result <= e on {frac:.3f} of lanes"
        else:
            extra = ""
        if counts:
            extra += (f", and with lane counts {', '.join(map(str, counts))}"
                      f" (the lanes past them INF)")
        build = wide_build(Wd) if name == "verify_fused_gather" else None
        if build:
            extra += (f"; thread-group kernel: "
                      f"{build['words']} words per thread, "
                      f"{build['threads']} threads per lane, "
                      f"{build['registers']} registers, "
                      f"{build['resident_warps']} resident warps per SM")
        b = bounds[name]
        log(f"kernel {name}: {L} lanes (m {m}: {Wd} read words, {Ww} window "
            f"words, {ncols} columns) equal to plain (max_abs_err {err}"
            f"{extra}); median {ms:.3f} ms ({fmt_ms(inside)} inside the"
            f" kernel) vs plain {plain_ms:.3f} ms;"
            f" bound {b['bound_ms']:.4f} ms by {b['bound_by']}"
            + (f" ({n_myers} lanes run Myers)"
               if name == "verify_fused_gather" else ""))
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                     "library_ms": None, "device_ms": inside, "lanes": L,
                     "read_words": Wd}
        if build:
            g, mhz = clocked_graph_ms(kern)
            log(f"kernel {name} m {m}, {L} lanes: CUDA graph {g:.4f} ms per "
                f"launch at {mhz} MHz (median SM clock meanwhile)")
            out[name].update(graph_ms=g, sm_mhz=mhz, myers_lanes=n_myers,
                             words_per_thread=build["words"],
                             threads_per_lane=build["threads"],
                             registers=build["registers"],
                             resident_warps=build["resident_warps"],
                             by_words_per_thread=wide_sweep(g_args, got, m))
    return out


def wide_sweep(g_args, want, m: int) -> dict:
    """Every build of the wide gathering verify on one bucket's lanes: its
    result held to the bucket's own build's (torch.equal), and its device
    ms per call from a CUDA graph, keyed by words per thread K (a lane on
    ceil(wd / K) threads)."""
    import torch

    from bitmapperbs_tpu_torch.ops import kernels

    Wd, out = m // 32, {}
    for k in sorted({k for k, _ in WIDE_BUILDS}):
        run = lambda k=k: kernels.verify_fused_gather(  # noqa: E731
            *g_args, words_per_thread=k)
        got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"verify_fused_gather m {m}, K {k}: "
                                 f"{int((got != want).sum())} lanes differ "
                                 f"from K {kernels.wide_words(Wd)}")
        out[k] = graph_ms(run)
    log(f"kernel verify_fused_gather m {m}, {want.numel()} lanes, each "
        f"build (equal results; CUDA graph, ms per launch): " + ", ".join(
            f"K {k} ({-(-Wd // k)} threads per lane) {ms:.4f}"
            for k, ms in out.items()))
    return out


def phase_wide_span(idx, dix, m: int = LONG_BUCKET,
                    read_len: int = LONG_READ_LEN,
                    n: int = 43_008) -> tuple[dict, tuple]:
    """The wide gathering verify on the same lanes over the 10 Mbp genome
    planes and over SPAN_TILES copies of them laid end to end, each lane's
    window moved into one copy (lane i into copy i mod SPAN_TILES): the same
    windows, the same results, the reads spread over ten times the bytes.
    Lanes whose window touches the genome's ends are left out of both (in a
    copy they would read the next copy, not N).  Returns the record and the
    one-copy call's arguments, which the Gbp phase times again."""
    import torch

    from bitmapperbs_tpu_torch.ops import kernels

    ncols, gw = m + 2 * E, dix.g_words
    Ww = -(-ncols // 32)
    _, _, _, _, _, lanes = kernel_inputs(idx, dix, n, seed=7, m=m,
                                         read_len=read_len)
    s = lanes["start"]
    keep = ((s >= 64) & (s + 32 * (Ww + 2) < dix.genome_len)).nonzero()[:, 0]
    o, s, r, ln = (lanes[k][keep] for k in ("orient", "start", "row",
                                            "lens"))
    tiled = dix.g_planes.view(2, gw, 3).repeat(1, SPAN_TILES, 1).reshape(
        2 * SPAN_TILES * gw, 3).contiguous()
    copy = torch.arange(keep.numel(), device=s.device) % SPAN_TILES
    one = (dix.g_planes, o, s, lanes["read_tab"], r, ln, dix.genome_len, gw,
           m, ncols, E)
    spread = (tiled, o, s + copy * 32 * gw, lanes["read_tab"], r, ln,
              SPAN_TILES * 32 * gw, SPAN_TILES * gw, m, ncols, E)
    want = kernels.verify_fused_gather_ref(*one)
    for args, what in ((one, "one copy"), (spread, f"{SPAN_TILES} copies")):
        got = kernels.verify_fused_gather(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"verify_fused_gather m {m} on {what}: "
                                 f"{int((got != want).sum())} lanes differ")

    def sector_mb(orient, start, gwords):
        # the 32-byte sectors under the plane rows the lanes' windows read
        # (rows (start + 32) / 32 + k, k <= Ww, 12 bytes each)
        rows = orient[:, None] * gwords + ((start[:, None] + 32) >> 5) \
            + torch.arange(Ww + 1, device=start.device)
        first = rows * 12 // 32
        return torch.unique(torch.cat([first, (rows * 12 + 11) // 32],
                                      dim=1)).numel() * 32 / 1e6

    times = {"one": [], "spread": []}
    for _ in range(2):                  # in turns: one, spread, one, spread
        times["one"].append(graph_ms(lambda: kernels.verify_fused_gather(
            *one)))
        times["spread"].append(graph_ms(lambda: kernels.verify_fused_gather(
            *spread)))
    clocked = clocked_graph_ms(lambda: kernels.verify_fused_gather(*one))
    out = {"lanes": int(keep.numel()), "m": m, "clocked_one": clocked,
           "plane_mb": [dix.g_planes.numel() * 4 / 1e6,
                        tiled.numel() * 4 / 1e6],
           "sector_mb": [sector_mb(o, s, gw),
                         sector_mb(o, spread[2], SPAN_TILES * gw)],
           "graph_ms_one": times["one"], "graph_ms_spread": times["spread"]}
    log(f"kernel verify_fused_gather m {m}, {out['lanes']} lanes equal to "
        f"plain on the genome planes ({out['plane_mb'][0]:.1f} MB) and on "
        f"{SPAN_TILES} copies ({out['plane_mb'][1]:.1f} MB, the lanes spread "
        f"over them; {out['sector_mb'][0]:.2f} / {out['sector_mb'][1]:.2f} "
        f"MB of 32-byte sectors read): CUDA graph, ms per launch, in turns: "
        f"one copy "
        + " / ".join(f"{t:.4f}" for t in times["one"]) + f", {SPAN_TILES} "
        "copies " + " / ".join(f"{t:.4f}" for t in times["spread"])
        + f"; one copy over {200 * 20} launches {clocked[0]:.4f} at "
        f"{clocked[1]} MHz")
    del tiled
    return out, one


def rescue_columns_run(r_ok, span, m: int, e: int, R: int,
                       chunks: int) -> int:
    """Myers columns that rescue_scan runs on these pairs (numpy lanes:
    r_ok bool, span u32 values), warm-up included: a pair's span + 1 output
    columns (span read as int32, at most R + e + 1; none without r_ok) are
    split over `chunks` threads, and each thread with columns starts m + e
    columns before its first one (clipped at column 0)."""
    import numpy as np

    span = np.asarray(span).astype(np.int64)
    span = np.where(span >= 1 << 31, span - (1 << 32), span)
    nout = np.where(np.asarray(r_ok) & (span >= 0),
                    np.minimum(span, R + e) + 1, 0)
    ch = -(-nout // chunks)
    jo, total = e + m - 1, 0
    for c in range(chunks):
        q0 = np.minimum(c * ch, nout)
        q1 = np.minimum(q0 + ch, nout)
        first = np.maximum(0, jo + q0 - (m + e))
        total += int(np.where(q0 < q1, jo + q1 - first, 0).sum())
    return total


def rescue_inputs(idx, dix, n: int, m: int, R: int):
    """n pairs' arguments of rescue_scan at bucket m and an insert range of
    R offsets: the missing mate somewhere in the window.  Most pairs carry
    the full span, as the path's do; planted: pairs without a window, spans
    of 0, spans that read negative as int32, random spans (hits fall
    outside), mates cut down to 8-12 bases (they reach a score <= e at many
    columns: equal minima, seconds within and beyond e of the best), and
    kernel_inputs' own wrapped starts, windows past the genome end and
    short mates.  Returns (args, r_ok, span), the last two as numpy."""
    import numpy as np
    import torch

    from bitmapperbs_tpu_torch.ops import verify
    from bitmapperbs_tpu_torch.ops.u32 import bnot, wrap

    _, _, _, peq, _, lanes = kernel_inputs(idx, dix, n, seed=11, span=R, m=m,
                                           read_len=m - 6)
    rng = np.random.default_rng(12)
    span = np.full(n, R - 1, np.int64)
    span[5::7] = rng.integers(0, R, len(span[5::7]))
    span[3::101] = 0
    span[4::103] = 0x80000000 + rng.integers(0, R, len(span[4::103]))
    r_ok = np.ones(n, bool)
    r_ok[2::53] = False
    ok = torch.from_numpy(r_ok).to(dix.device)
    # rows past a mate's length always match: cutting a mate down is OR-ing
    # the new pad rows into its PEQ
    lens = lanes["lens"].clone()
    lens[6::97] = 8 + torch.arange(len(lens[6::97]), device=dix.device) % 5
    pad = bnot(verify.length_mask(lens, m))
    args = (dix.g_planes, lanes["orient"], torch.where(ok, lanes["start"], 0),
            ok, wrap(lanes["start"] + E),
            torch.from_numpy(span).to(dix.device), lens,
            peq | pad[:, None, :], pad, dix.genome_len, dix.g_words, m, E, R)
    return args, r_ok, span


def phase_rescue_kernel(idx, dix) -> dict:
    """rescue_scan vs its plain version at the PE rescue shape (one pair per
    lane, insert window 0-500: 605 columns), timed; then at
    WIDE_RESCUE_SHAPES, checked."""
    import torch

    from bitmapperbs_tpu_torch.ops import kernels

    def check(args, want, what) -> int:
        got = kernels.rescue_scan(*args)
        torch.cuda.synchronize()
        err = 0
        for name, g, w in zip(("rs_best", "rp_best", "rs_second"), got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            err = max(err, int((g.to(torch.int64)
                                - w.to(torch.int64)).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(
                    f"rescue_scan ({what}): {name} differs from plain on "
                    f"{int((g != w).sum())} of {g.numel()} pairs")
        return err

    m, R = BUCKET, MAX_INSERT - MIN_INSERT + 1
    Wd, Ww = m // 32, -(-(R + m + 2 * E) // 32)
    chunks, two_pass = kernels.rescue_scan_chunks(m, E, R)
    assert not two_pass
    out = None
    for n in SCAN_LANES:
        args, r_ok, span = rescue_inputs(idx, dix, n, m, R)
        want = kernels.rescue_scan_ref(*args)
        torch.cuda.synchronize()
        err = check(args, want, f"{n} pairs")
        hit = float((want[0] <= E).float().mean())
        second = float((want[2] <= E).float().mean())
        assert 0 < second < hit < 1, (second, hit)
        msg = (f"kernel rescue_scan: {n} pairs x {R + m + 2 * E} columns "
               f"equal to plain (max_abs_err {err}; a hit on {hit:.3f} of "
               f"pairs, a second one more than e away on {second:.3f})")
        if out is None:
            # per pair: 5 int64 lanes and a bool, 5 Wd int64 PEQ / pad
            # words, Ww + 1 plane rows of 12 bytes, 16 bytes out
            nbytes = n * (41 + 40 * Wd + 12 * (Ww + 1) + 16)
            c = SASS_OPS["rescue_scan"]
            # what the function needs: one scan per pair over its valid
            # columns; what the kernel runs: `chunks` scans per pair, each
            # with its warm-up
            needed = rescue_columns_run(r_ok, span, m, E, R, 1)
            run = rescue_columns_run(r_ok, span, m, E, R, chunks)
            b = bound(nbytes, n * c["once"] + needed * c["loop"])
            b_run = bound(nbytes, n * chunks * c["once"] + run * c["loop"])
            ms = median_ms(lambda: kernels.rescue_scan(*args))
            inside = device_ms(lambda: kernels.rescue_scan(*args),
                               "rescue_scan_kernel")
            plain_ms = median_ms(lambda: kernels.rescue_scan_ref(*args),
                                 reps=PLAIN_SCAN_REPS)
            msg += (f"; {chunks} threads per pair: median {ms:.4f} ms "
                    f"({fmt_ms(inside)} inside the kernel) vs plain "
                    f"{plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms by "
                    f"{b['bound_by']} for the {needed} columns the function "
                    f"needs ({needed / n:.1f} per pair); the kernel runs "
                    f"{run} ({run / n:.1f} per pair, warm-up included), "
                    f"which alone would take {b_run['bound_ms']:.4f} ms")
            out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                   "library_ms": None, "device_ms": inside,
                   "columns_needed": needed, "columns_run": run,
                   "bound_ms_columns_run": b_run["bound_ms"],
                   "threads_per_pair": chunks}
        else:
            out["max_abs_err"] = max(out["max_abs_err"], err)
        log(msg)
    for m, R, n, chunks in WIDE_RESCUE_SHAPES:
        two_pass = kernels.rescue_scan_chunks(m, E, R)[1]
        assert kernels.rescue_scan_chunks(m, E, R) == (chunks, two_pass)
        assert two_pass == (R > 58_107 if m <= 256 else R > 37_627), (m, R)
        args, r_ok, span = rescue_inputs(idx, dix, n, m, R)
        t0 = time.perf_counter()
        if two_pass:
            # the plain scan is one loop step of ~30 small ops per column;
            # at 60,000-100,000 columns the host's CPU runs it sooner than
            # the card's per-op dispatch does
            with torch.inference_mode():
                want = tuple(t.to(dix.device) for t in kernels.rescue_scan_ref(
                    *(a.cpu() if isinstance(a, torch.Tensor) else a
                      for a in args)))
        else:
            want = kernels.rescue_scan_ref(*args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        before = kernels.LAUNCHES["rescue_scan"]
        out["max_abs_err"] = max(out["max_abs_err"], check(
            args, want, f"m {m}, {R} offsets, {chunks} threads per pair"))
        assert kernels.LAUNCHES["rescue_scan"] - before == 1 + two_pass
        msg = (f"kernel rescue_scan: {n} pairs x {R + m + 2 * E} columns at "
               f"m {m} ({m // 32} read words"
               + (", PEQ in shared memory" if m > 256 else "")
               + f"), {chunks} threads per pair"
               + (" in two passes" if two_pass else "")
               + f", equal to plain (a hit on "
               f"{float((want[0] <= E).float().mean()):.3f} of pairs, a "
               f"second one on {float((want[2] <= E).float().mean()):.3f}; "
               f"plain {plain_s:.1f} s"
               + (" on the host's CPU" if two_pass else "") + ")")
        if two_pass and m == BUCKET:
            out["two_pass"] = two_pass_record(args, want, r_ok, span, m, R)
            tp = out["two_pass"]
            msg += (f"; pass 1 {fmt_ms(tp['pass1_device_ms'])} ms inside "
                    f"(bound {tp['pass1_bound_ms']:.4f}), pass 2 "
                    f"{fmt_ms(tp['pass2_device_ms'])} ms inside (bound "
                    f"{tp['pass2_bound_ms']:.4f}), call {tp['ms']:.4f} ms; "
                    f"the function's bound {tp['bound_ms']:.4f} ms by "
                    f"{tp['bound_by']} ({tp['columns_needed']} columns)")
        log(msg)
    return out


def two_pass_record(args, want, r_ok, span, m: int, R: int) -> dict:
    """Times of the two-pass mode at one shape: each pass inside the kernel
    beside its bound (pass 1 scans every pair with a window, pass 2 only
    those with a hit; each at its own instructions per column), the
    wrapper's call, and the function's bound (one scan per pair over its
    valid columns, at the one-pass kernel's instructions per column)."""
    import numpy as np
    import torch

    from bitmapperbs_tpu_torch.ops import kernels

    n = len(r_ok)
    Ww = -(-(R + m + 2 * E) // 32)
    nbytes = n * (41 + 40 * (m // 32) + 12 * (Ww + 1) + 16)
    hit = np.asarray(want[0].cpu()) <= E
    # each pass's bound: the columns it must scan (pass 2 only on pairs with
    # a hit), without the warm-up its 32 threads per pair add
    needed = rescue_columns_run(r_ok, span, m, E, R, 1)
    needed2 = rescue_columns_run(r_ok & hit, span, m, E, R, 1)
    run1 = rescue_columns_run(r_ok, span, m, E, R, 32)
    run2 = rescue_columns_run(r_ok & hit, span, m, E, R, 32)
    c0, c1, c2 = (SASS_OPS[k] for k in ("rescue_scan", "rescue_scan pass 1",
                                        "rescue_scan pass 2"))
    call = lambda: kernels.rescue_scan(*args)        # noqa: E731
    return {"ms": median_ms(call, reps=5),
            "pass1_device_ms": device_ms(call, "rescue_scan_kernel<3, false, "
                                               "1, ", reps=3),
            "pass2_device_ms": device_ms(call, "rescue_scan_kernel<3, false, "
                                               "2, ", reps=3),
            **bound(nbytes, n * c0["once"] + needed * c0["loop"]),
            "pass1_bound_ms": bound(nbytes, n * c1["once"]
                                    + needed * c1["loop"])["bound_ms"],
            "pass2_bound_ms": bound(nbytes, n * c2["once"]
                                    + needed2 * c2["loop"])["bound_ms"],
            "columns_needed": needed, "columns_run_pass1": run1,
            "columns_run_pass2": run2, "pairs": n, "pairs_with_a_hit":
            int(hit.sum()), "insert_range": R, "m": m}


def low_complexity_reads(n: int, seed: int, bases=None):
    """Pyrimidine-only reads (or from `bases`): C->T conversion turns them
    into poly-T, whose seeds hit tens of loci each on the converted
    genome."""
    import numpy as np

    from bitmapperbs_tpu_torch import constants as K

    lo, hi = bases or (K.C, K.T)
    rng = np.random.default_rng(seed)
    return list(np.where(rng.random((n, READ_LEN)) < 0.5, lo,
                         hi).astype(np.uint8))


def tandem_genome_fasta(seed: int) -> str:
    """chr1 = 3 kb unique + 200 copies of a random 20 bp unit + 3 kb unique;
    chr2 = 2 kb unique.  Every seed of a read inside the repeat occurs ~200
    times, past max_seed_occ (128): such a mate has no SE hit, and only the
    rescue pass next to its unique mate places it."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def seq(n):
        return "".join(rng.choice(list("ACGT"), n))
    chr1 = seq(3000) + seq(20) * 200 + seq(3000)
    return f">chr1\n{chr1}\n>chr2\n{seq(2000)}\n"


def straddling_pairs(idx, n: int, seed: int, read_len: int = 80):
    """n OT/OB fragments of read_len * 2 + 0..79 bp across a boundary of
    tandem_genome_fasta's repeat: one read in the unique flank, the other
    wholly inside the repeat."""
    import numpy as np

    from bitmapperbs_tpu_torch import constants as K
    from bitmapperbs_tpu_torch.utils import dna

    rng = np.random.default_rng(seed)
    g = np.asarray(idx.genome.codes)
    base = int(idx.genome.offsets[0])
    pairs = []
    for k in range(n):
        b = base + (3000 if k % 2 else 7000)
        s = b - read_len - int(rng.integers(0, 20))
        frag = g[s:b + int(rng.integers(0, 60)) + read_len].copy()
        if rng.integers(0, 2):
            frag = dna.revcomp(frag)                # OB
        frag[(frag == K.C) & (rng.random(len(frag)) < 0.7)] = K.T
        pairs.append((frag[:read_len].copy(),
                      dna.revcomp(frag)[:read_len].copy()))
    return pairs


def pair_join_grids(seed: int, B: int, Kc: int, frames1, frames2, L: int,
                    e: int, min_insert: int, max_insert: int,
                    stray: bool = False) -> dict:
    """Seeded inputs of the pair join (numpy: s1 / s2 int32 [B, F, Kc]
    scores, f1 / f2 int64 [B, F, Kc] u32 fwd anchors, m1 / m2 int64 [B]).
    Per pair a locus; per compatible frame pair 0..Kc candidates of each
    mate in random slots (mostly a few, now and then many), mate 2 placed
    at inserts from a little below min_insert to a little above
    max_insert, so that cells are ok and not ok, with duplicate anchors,
    loci near 0 and near L (u32 wrap) and scores 0..e.  An empty slot holds
    INF and INVALID, as the candidate stages leave it, or with `stray` a
    random anchor (the kernel's degenerate candidate reads every slot)."""
    import numpy as np

    from bitmapperbs_tpu_torch import constants as K
    from bitmapperbs_tpu_torch.ops.kernels import frame_pairs

    rng = np.random.default_rng(seed)
    INF, INV, U = K.INF_SCORE, 0xFFFFFFFF, 1 << 32
    grids = {"s1": np.full((B, len(frames1), Kc), INF, np.int32),
             "f1": np.full((B, len(frames1), Kc), INV, np.int64),
             "s2": np.full((B, len(frames2), Kc), INF, np.int32),
             "f2": np.full((B, len(frames2), Kc), INV, np.int64),
             "m1": rng.integers(20, 150, B).astype(np.int64),
             "m2": rng.integers(20, 150, B).astype(np.int64)}
    if stray:
        for k in ("f1", "f2"):
            grids[k][:] = rng.integers(0, U, grids[k].shape)
    for b in range(B):
        where = rng.random()
        locus = int(rng.integers(0, 300) if where < 0.1 else
                    rng.integers(L - 300, L) if where < 0.2 else
                    rng.integers(0, L))
        m1, m2 = int(grids["m1"][b]), int(grids["m2"][b])
        for i1, i2, _, _, fwd1 in frame_pairs(frames1, frames2):
            for side, fr, n_max in (("1", i1, Kc), ("2", i2, Kc)):
                n = int(rng.integers(0, min(n_max, 4) + 1)
                        if rng.random() < 0.9 else rng.integers(0, n_max + 1))
                slots = rng.choice(Kc, n, replace=False)
                near = rng.integers(-e - 2, e + 3, n)
                if side == "1":
                    f = locus + near
                else:
                    ins = rng.integers(min_insert - 3, max_insert + 4, n)
                    f = locus + near + (ins - m2 if fwd1 else m1 - ins)
                if n > 1 and rng.random() < 0.3:
                    f[1] = f[0]                      # a duplicate anchor
                grids["s" + side][b, fr, slots] = rng.integers(0, e + 1, n)
                grids["f" + side][b, fr, slots] = f % U
    return grids


def plant_pair_join_rows(grids: dict, frames1, frames2, L: int, e: int,
                         min_insert: int, max_insert: int) -> int:
    """Writes the pair join's edge rows over the first rows of `grids`
    (pair_join_grids' layout), every other frame of such a row emptied:
    no ok cell; both sides empty; mate 1 empty; duplicate mate-1 and mate-2
    anchors with unequal scores; inserts at exactly min_insert (or at the
    mates' length of 40 where min_insert is below it) and max_insert, one
    past max_insert, and the forward mate after the
    reverse one; anchors near 0 and near L, where the frame anchor of a
    reverse-block read wraps below 0; mate-1 anchors e and e + 1 from the
    best (the second-best's distance rule) and a second in another frame
    pair.  Returns the number of rows written."""
    from bitmapperbs_tpu_torch import constants as K
    from bitmapperbs_tpu_torch.ops.kernels import frame_pairs

    INF, INV, U = K.INF_SCORE, 0xFFFFFFFF, 1 << 32
    fps = frame_pairs(frames1, frames2)
    m1 = m2 = 40
    rows = []

    def mate2(f1, insert, fp):
        """The mate-2 anchor at this insert from a mate-1 anchor f1."""
        return (f1 + insert - m2 if fp[4] else f1 + m1 - insert) % U

    # no proper pair has an insert below the reverse mate's length (the
    # forward mate would start after it): the least insert that can be ok
    lo, hi = max(min_insert, m1), max_insert
    p0, p1 = fps[0], fps[-1]
    rows.append({p0: ([(1, 1000)], [(0, mate2(1000, hi + 500, p0))])})
    rows.append({})
    rows.append({p0: ([], [(2, 5000)])})
    rows.append({p0: ([(2, 3000), (1, 3000), (0, 3000 + 2 * e + 5)],
                      [(1, mate2(3000, lo, p0)), (0, mate2(3000, lo, p0)),
                       (0, mate2(3000 + 2 * e + 5, hi, p0))])})
    rows.append({p0: ([(3, 7000)], [(1, mate2(7000, lo, p0))])})
    rows.append({p0: ([(1, 7000)], [(1, mate2(7000, hi, p0))])})
    rows.append({p0: ([(0, 7000), (2, 7100)],
                      [(0, mate2(7000, hi + 1, p0)),
                       (2, mate2(7100, hi, p0))])})
    rows.append({p0: ([(0, 9000)], [(0, (9000 - 50) % U if p0[4]
                                     else (9000 + 50) % U)])})
    rows.append({p0: ([(1, 0), (0, 1)], [(1, mate2(0, lo, p0)),
                                         (2, mate2(1, hi, p0))]),
                 p1: ([(1, L - m1 + 3), (0, L - m1 - 1)],
                      [(2, mate2(L - m1 + 3, hi, p1)),
                       (1, mate2(L - m1 - 1, lo, p1))])})
    rows.append({p0: ([(0, 20000), (1, 20000 + e), (1, 20000 + e + 1)],
                      [(0, mate2(20000, lo, p0)),
                       (0, mate2(20000 + e, lo, p0)),
                       (1, mate2(20000 + e + 1, lo, p0))]),
                 p1: ([(2, 20000)], [(0, mate2(20000, lo, p1))])})
    Kc = grids["s1"].shape[2]
    for b, row in enumerate(rows):
        for k in ("s1", "s2"):
            grids[k][b] = INF
        for k in ("f1", "f2"):
            grids[k][b] = INV
        grids["m1"][b], grids["m2"][b] = m1, m2
        for (i1, i2, *_), (side1, side2) in row.items():
            for fr, side, ents in (("1", i1, side1), ("2", i2, side2)):
                for slot, (sc, f) in zip(range(Kc - 1, -1, -1), ents):
                    grids["s" + fr][b, side, slot] = sc
                    grids["f" + fr][b, side, slot] = f % U
    return len(rows)


def flat_expand_inputs(seed: int, B: int, F: int, S: int, max_occ: int,
                       LB: int, shared_starts: bool = True) -> dict:
    """Seeded inputs of the flat expansion (numpy: sp / ep int64 [B, F, S]
    u32 seed intervals, starts int64 [B, 1, S] (one per read, as seeding
    leaves them) or [B, F, S] (moved by the seed extension), lengths int64
    [B]).  A seed's width is 0, small, up to max_occ, above it, or wrapped
    below 0 (ep < sp); the first reads are edge reads: no kept seed, only
    seeds over max_occ or wrapped, a total over LB (runs cut at the budget),
    equal counts in every frame (the order's ties), a frame of exactly LB,
    and one kept seed of width 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    U = 1 << 32
    sp = rng.integers(0, U, (B, F, S))
    kind = rng.random((B, F, S))
    width = np.where(
        kind < 0.35, 0, np.where(
            kind < 0.7, rng.integers(1, 5, (B, F, S)), np.where(
                kind < 0.9, rng.integers(5, max_occ + 1, (B, F, S)),
                np.where(kind < 0.95,
                         rng.integers(max_occ + 1, 4 * max_occ + 2, (B, F, S)),
                         -rng.integers(1, 10, (B, F, S))))))
    edges = [np.zeros((F, S), np.int64),                    # nothing kept
             np.where(np.arange(S) % 2, max_occ + 1, -3)[None].repeat(F, 0),
             np.full((F, S), max_occ),                      # total > LB
             np.full((F, S), 3),                            # ties
             np.where(np.arange(S) == 0, min(LB, max_occ), 0)[None].repeat(
                 F, 0),
             np.where(np.arange(S) == S - 1, 1, 0)[None].repeat(F, 0)]
    for b, w in enumerate(edges[:B]):
        width[b] = w
    starts = np.sort(rng.integers(0, 90, (B, 1 if shared_starts else F, S)),
                     axis=-1)
    return {"sp": sp, "ep": (sp + width) % U, "starts": starts,
            "lengths": rng.integers(40, 97, B).astype(np.int64)}


def flat_cap_cuts(n_used: int, frame_occ, CAP: int) -> list:
    """Buffer sizes of the expansion's edge cases for a batch whose frames
    fill n_used slots (frame_occ: each frame's slots, in order): the
    batch's own CAP, one slot, a cut inside a frame's run (n_used > CAP:
    every slot filled, the reads past it dropped), a cut at a frame's
    boundary, exactly n_used and past it."""
    import numpy as np

    base = np.cumsum(frame_occ) - frame_occ
    big = np.flatnonzero(frame_occ >= 3)
    inside = int(base[big[len(big) // 2]] + 1) if len(big) else 1
    bounds = base[(base > 0) & (base < n_used)]
    at = int(bounds[len(bounds) // 2]) if len(bounds) else 1
    return sorted({CAP, 1, max(inside, 1), max(at, 1), max(n_used, 1),
                   n_used + 5})


def flat_sorted_keys(seed: int, B: int, F: int, Kc: int, CAP: int,
                     L: int) -> dict:
    """Seeded sorted keys of the flat dedup (numpy: keyS / perm int64 [CAP],
    len_b int64 [CAP] per unsorted lane, overflow bool [B, F]): keys row <<
    32 | anchor of R = B * F rows (row R with anchor INVALID for a lane
    without an anchor), anchors repeated within a row and across rows, near
    0 and near L (the reverse block's fwd anchor wraps).  Edge rows: row 0
    with Kc + 7 distinct anchors and duplicates, row 1 with no lane (an
    all-INVALID frame), rows 2 and 3 with the same anchors, the last row
    with one lane."""
    import numpy as np

    rng = np.random.default_rng(seed)
    R = B * F
    INV = 0xFFFFFFFF
    rows = rng.integers(4, R, CAP)
    rows[rng.random(CAP) < 0.2] = R
    pick = rng.random(CAP)
    anchor = np.where(pick < 0.5, rng.integers(0, 60, CAP), np.where(
        pick < 0.7, rng.integers(max(L - 120, 0), L + 1, CAP),
        rng.integers(0, INV, CAP)))
    n0 = min(2 * (Kc + 7), CAP // 4)
    rows[:n0] = 0
    anchor[:n0] = np.arange(n0) % (Kc + 7) * 3
    shared = rng.integers(0, 1000, 16)
    rows[n0:n0 + 16], anchor[n0:n0 + 16] = 2, shared
    rows[n0 + 16:n0 + 32], anchor[n0 + 16:n0 + 32] = 3, shared
    rows[n0 + 32:][rows[n0 + 32:] == R - 1] = R
    rows[n0 + 32] = R - 1
    anchor[rows == R] = INV
    key = rows.astype(np.int64) << 32 | anchor
    lengths = rng.integers(40, 97, B)
    len_b = np.where(rows < R, lengths[np.minimum(rows, R - 1) // F], 0)
    return {"key": key.astype(np.int64), "len_b": len_b.astype(np.int64),
            "overflow": rng.random((B, F)) < 0.1,
            "lengths": lengths.astype(np.int64)}


def flat_scores(seed: int, keep, e: int):
    """Seeded verify scores (numpy int32) of the sorted lanes: 0..e, just
    over e and INF, INF on most lanes that are not kept, as the verify
    leaves them past n_valid."""
    import numpy as np

    from bitmapperbs_tpu_torch import constants as K

    rng = np.random.default_rng(seed)
    n = len(keep)
    score = np.where(rng.random(n) < 0.6, rng.integers(0, e + 1, n),
                     np.where(rng.random(n) < 0.5,
                              rng.integers(e + 1, e + 4, n), K.INF_SCORE))
    score[~keep & (rng.random(n) < 0.7)] = K.INF_SCORE
    return score.astype(np.int32)


def select_grids(seed: int, B: int, frames, Kc: int, e: int,
                 L: int) -> dict:
    """Seeded (B, F, Kc) grids of the selection (numpy: score int32, fwd /
    frame_a int64 u32 values, INF / INVALID in empty slots, as the
    candidate stages leave them; bp int64 [F], the frames' codes).  Edge
    reads: nothing valid; two hits of one score at other fwd anchors; one
    score and fwd in two frames (bp decides); one (score, fwd, bp) at two
    frame anchors; seconds exactly e and e + 1 from the best; the best in
    the last slot of the last frame."""
    import numpy as np

    from bitmapperbs_tpu_torch import constants as K

    rng = np.random.default_rng(seed)
    F = len(frames)
    INF, INV = K.INF_SCORE, 0xFFFFFFFF
    score = np.full((B, F, Kc), INF, np.int32)
    fwd = np.full((B, F, Kc), INV, np.int64)
    frame_a = np.full((B, F, Kc), INV, np.int64)
    for b in range(B):
        n = int(rng.integers(0, min(Kc, 6) + 1) if rng.random() < 0.9
                else rng.integers(0, F * Kc + 1))
        at = rng.choice(F * Kc, n, replace=False)
        locus = int(rng.integers(0, L))
        fa = locus + rng.integers(-2 * e, 2 * e + 1, n)
        score.reshape(B, -1)[b, at] = rng.integers(0, e + 1, n)
        frame_a.reshape(B, -1)[b, at] = fa % (1 << 32)
        fwd.reshape(B, -1)[b, at] = (fa + rng.integers(0, 3, n)) % (1 << 32)
    plants = [
        [],
        [(0, 0, 1, 500, 500), (1, 2, 1, 400, 400)],
        [(0, 1, 2, 900, 900), (F - 1, 0, 2, 900, 950)],
        [(0, 3, 0, 70, 80), (0, 4, 0, 70, 75)],
        [(0, 0, 0, 300, 300), (0, 1, 1, 300 + e, 300 + e),
         (0, 5, 2, 300 + e + 1, 300 + e + 1)],
        [(0, 0, 3, 10, 10), (F - 1, Kc - 1, 0, 20, 20)],
    ]
    for b, row in enumerate(plants[:B]):
        score[b], fwd[b], frame_a[b] = INF, INV, INV
        for f, k, sc, fw, fa in row:
            score[b, f, min(k, Kc - 1)] = sc
            fwd[b, f, min(k, Kc - 1)] = fw
            frame_a[b, f, min(k, Kc - 1)] = fa
    return {"score": score, "fwd": fwd, "frame_a": frame_a,
            "bp": np.array([bl * 2 + p for p, bl in frames], np.int64)}


def recall(idx, sims, recs) -> float:
    """Share of the simulated reads placed on the true contig and strand
    within e of the true leftmost coordinate."""
    from bitmapperbs_tpu_torch import constants as K

    ok = 0
    for s, r in zip(sims, recs):
        if r.flag & K.FLAG_UNMAPPED:
            continue
        ok += (r.rname == idx.genome.names[s.contig]
               and abs((r.pos - 1) - s.coord) <= E
               and bool(r.flag & K.FLAG_REVERSE) == s.is_reverse)
    return ok / len(sims)


def cli_cmd(args, prefix: str) -> list:
    """`search` of the port's CLI on the card (never --platform cpu)."""
    return [sys.executable, "-m", "bitmapperbs_tpu_torch", "search", prefix,
            *args, "--platform", "gpu"]


def cli_run(args, prefix: str) -> str:
    """Runs cli_cmd to its end; returns its stderr, raises on failure."""
    proc = subprocess.run(cli_cmd(args, prefix), cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"CLI {args} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return proc.stderr


def sam_records(path: str) -> list:
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if not ln.startswith("@")]


def bam_record_bytes(data: bytes) -> bytes:
    """The alignment records of a BAM file, decompressed, header skipped."""
    import gzip
    import struct

    raw = gzip.decompress(data)
    assert raw[:4] == b"BAM\1"
    l_text, = struct.unpack_from("<i", raw, 4)
    off = 8 + l_text
    n_ref, = struct.unpack_from("<i", raw, off)
    off += 4
    for _ in range(n_ref):
        l_name, = struct.unpack_from("<i", raw, off)
        off += 8 + l_name
    return raw[off:]


def reset_launches() -> None:
    from bitmapperbs_tpu_torch.ops import kernels

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0


def run_se(idx, dix, card: str, prefix: str, workdir: str):
    """SE phases 4-7; returns phase 4's and phase 5's launch counts and
    phase 6's CLI run (its FASTQ in workdir, records and stats) for phase
    11b."""
    import torch

    from bitmapperbs_tpu_torch.config import AlignerConfig
    from bitmapperbs_tpu_torch.io.fastq import write_fastq
    from bitmapperbs_tpu_torch.oracle.pipeline import map_batch_se
    from bitmapperbs_tpu_torch.utils.simulate import simulate_reads
    from bitmapperbs_tpu_torch.models import graphs as device_graphs
    from bitmapperbs_tpu_torch.models.aligner import map_batch_device
    from bitmapperbs_tpu_torch.models.host import map_batch, prepare_batch
    from bitmapperbs_tpu_torch.ops import kernels

    device = dix.device

    # ---- phase 4: SE main path ----------------------------------------------
    cfg = AlignerConfig(max_errors=E, indels=True, read_len_bucket=BUCKET,
                        batch_size=BATCH)
    sims = [simulate_reads(idx.genome, BATCH, read_len=READ_LEN, seed=10 + i,
                           sub_rate=0.01, indel_rate=0.005)
            for i in range(N_TIMED_BATCHES)]
    n_main = N_MAIN_BATCHES * BATCH
    main_sims = [s for b in sims[:N_MAIN_BATCHES] for s in b][:n_main
                                                              - N_LOWCX]
    reads = [s.codes for s in main_sims] + low_complexity_reads(N_LOWCX, 99)
    quals = [s.qual for s in main_sims] + ["I" * READ_LEN] * N_LOWCX
    qnames = [f"r{i}" for i in range(len(reads))]
    reset_launches()
    t0 = time.perf_counter()
    recs = map_batch(idx, dix, cfg, reads, quals, qnames, graphs=False)
    main_launches = dict(kernels.LAUNCHES)
    log(f"main path: {len(reads)} reads mapped in "
        f"{time.perf_counter() - t0:.2f} s (first call, eager), launches "
        f"{main_launches}")
    assert len(recs) == len(reads)
    # no seed extension below 512 Mbp: fm_extend belongs to phases 12-13
    for name in ("verify_fused_gather", "fm_search", "fm_locate",
                 *FLAT_KERNELS):
        assert main_launches[name] > 0, f"{name} never ran on the SE path"
    assert main_launches["myers"] > 0, \
        "Myers kernel never ran: no batch took the gdrop dense re-run"
    lines = [r.line() for r in recs]
    for lo, hi in ((0, N_ORACLE), (n_main - N_ORACLE_LOWCX, n_main)):
        oracle = [r.line() for r in map_batch_se(idx, cfg, reads[lo:hi],
                                                 quals[lo:hi],
                                                 qnames[lo:hi])]
        bad = [i for i, (a, b) in enumerate(zip(oracle, lines[lo:hi]))
               if a != b]
        assert not bad, f"oracle mismatch at read {lo + bad[0]}:\n" \
                        f"{oracle[bad[0]]}\n{lines[lo + bad[0]]}"
    mapped = sum(not r.flag & 4 for r in recs) / len(recs)
    log(f"main path: SAM of reads [0, {N_ORACLE}) and the last "
        f"{N_ORACLE_LOWCX} (low-complexity, gdrop re-run) equals the oracle;"
        f" mapped {mapped:.4f}, recall of the simulated reads "
        f"{recall(idx, main_sims, recs):.4f}")
    t0 = time.perf_counter()
    grecs, replays, live = graph_path(
        "se_10mbp_graph", dix,
        lambda: map_batch(idx, dix, cfg, reads, quals, qnames))
    assert [r.line() for r in grecs] == lines, \
        "SE records through CUDA graphs differ from the eager run's"
    log(f"main path through CUDA graphs: {len(reads)} reads in "
        f"{time.perf_counter() - t0:.2f} s (captures included), {replays} "
        f"replays of {len(live)} graph(s), records equal to the eager run's; "
        f"the replays launched {GRAPH_PATHS['se_10mbp_graph']}")

    # ---- phase 5: gdrop dense fallback forced for a whole batch -------------
    cfg_g = cfg.replace(locate_flat_cap=1)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(device)
    recs_g = map_batch(idx, dix, cfg_g, reads[:BATCH], quals[:BATCH],
                       qnames[:BATCH], graphs=False)
    gdrop_launches = dict(kernels.LAUNCHES)
    assert gdrop_launches["myers"] > 0, "Myers kernel never ran (forced)"
    assert [r.line() for r in recs_g] == lines[:BATCH], "gdrop SAM differs"
    log(f"forced gdrop: {BATCH} reads re-run dense, SAM equal to phase 4; "
        f"launches {gdrop_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")

    # ---- phase 6: SE CLI, with the spawned finalize pool beside CUDA ---------
    fq = os.path.join(workdir, "reads.fq")
    write_fastq(fq, reads, qnames, quals)
    out = os.path.join(workdir, "out.sam")
    t0 = time.perf_counter()
    cli_run(["--seq", fq, "-o", out, "--read-bucket", str(BUCKET),
             "--batch-size", str(BATCH), "-t", str(CLI_THREADS),
             "--stats-json", out + ".json"], prefix)
    wall = time.perf_counter() - t0
    cli = sam_records(out)
    assert cli == lines, "CLI records differ from map_batch's"
    with open(out + ".json") as f:
        cli_stats = json.load(f)
    log(f"CLI (-t {CLI_THREADS}): {len(cli)} records equal to phase 4 "
        f"({wall:.2f} s incl. start-up)")

    # ---- phase 7: SE throughput ---------------------------------------------
    dev_batches = []
    for b in sims:
        a, ln = prepare_batch([s.codes for s in b], BUCKET, BATCH)
        dev_batches.append((torch.from_numpy(a).to(device),
                            torch.from_numpy(ln).to(device), int(ln.min())))
    map_batch_device(dix, cfg, *dev_batches[0][:2],
                     min_read_len=dev_batches[0][2])["best_score"].cpu()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    outs = [map_batch_device(dix, cfg, a, ln, min_read_len=mn)
            for a, ln, mn in dev_batches]
    for o in outs:
        o["best_score"].cpu()
    dev_rps = len(dev_batches) * BATCH / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    del outs
    e2e_rps, e2e_lo, e2e_hi, recs = host_rates(
        lambda: map_batch(idx, dix, cfg, reads, quals, qnames), len(reads))
    assert [r.line() for r in recs] == lines
    log(f"throughput: map_batch_device {dev_rps:.1f} reads/s over "
        f"{len(dev_batches)} simulated batches of {BATCH} (peak device "
        f"memory {peak:.2f} GB); end-to-end map_batch {e2e_rps:.1f} reads/s "
        f"(median of {E2E_REPS} runs, {e2e_lo:.1f}-{e2e_hi:.1f}) "
        f"over phase 4's {N_MAIN_BATCHES} batches (one gdrop re-run), on "
        f"{card}")

    # ---- CUDA graphs against eager on phase 4's batches ---------------------
    batches = host_batches(reads, BUCKET, BATCH, pe=False)
    graphs_vs_eager("10 Mbp SE, phase 4's batches", dix, cfg, batches, False)
    graph_walls("10 Mbp SE", dix, cfg, batches, False, card)
    device_graphs.clear(dix)

    # ---- phase 3 addition: the flat-buffer kernels on the arguments of
    # phase 4's last batch (its low-complexity reads overflow the buffer:
    # n_used > CAP, the gdrop case)
    phase_flat_kernels({"10 Mbp SE, phase 4's last batch": capture_flat_args(
        lambda: eager_call(dix, cfg, batches[-1], False))}, {}, card)

    return main_launches, gdrop_launches, {
        "fq": fq, "lines": lines, "stats": cli_stats, "cli_s": wall,
        "cfg": cfg, "reads": reads, "quals": quals, "qnames": qnames}


def pe_inputs(idx):
    """Phase 8's pairs: simulated batches (the first N_PE_MAIN_BATCHES feed
    the main path, all of them the throughput phase), the seed-killed and
    low-complexity groups ending the main path."""
    import numpy as np

    from bitmapperbs_tpu_torch import constants as K
    from bitmapperbs_tpu_torch.utils.simulate import simulate_pairs

    sims = [simulate_pairs(idx.genome, PE_PAIRS, read_len=READ_LEN,
                           seed=50 + i, sub_rate=0.01, indel_rate=0.005,
                           min_insert=150, max_insert=480)
            for i in range(N_PE_TIMED_BATCHES)]
    n_main = N_PE_MAIN_BATCHES * PE_PAIRS
    main = [p for b in sims[:N_PE_MAIN_BATCHES] for p in b][:n_main
                                                           - N_PE_LOWCX]
    pairs = [(a.codes, b.codes) for a, b in main]
    rng = np.random.default_rng(98)
    r0 = len(pairs) - N_PE_RESCUE
    for i in range(r0, len(pairs)):
        r2 = pairs[i][1].copy()
        for j in KILL_POS:
            r2[j] = (r2[j] + 1 + rng.integers(0, 3)) % 4
        pairs[i] = (pairs[i][0], r2)
    pairs += list(zip(low_complexity_reads(N_PE_LOWCX, 97),
                      low_complexity_reads(N_PE_LOWCX, 96, (K.A, K.G))))
    quals = [(a.qual, b.qual) for a, b in main] + \
        [("I" * READ_LEN,) * 2] * N_PE_LOWCX
    qnames = [f"p{i}" for i in range(len(pairs))]
    return sims, main, pairs, quals, qnames, r0


def run_pe(idx, dix, card: str, prefix: str, workdir: str):
    """PE phases 8-11; returns phase 8's and phase 9's launch counts and
    what phase 11b reuses: phase 10's FASTQs (in workdir), the records, the
    pairs and the configuration."""
    import torch

    from bitmapperbs_tpu_torch import constants as K
    from bitmapperbs_tpu_torch.config import AlignerConfig
    from bitmapperbs_tpu_torch.index.build import build_index
    from bitmapperbs_tpu_torch.io.fastq import write_fastq
    from bitmapperbs_tpu_torch.oracle.paired import map_batch_pe as oracle_pe
    from bitmapperbs_tpu_torch.index.device import upload_index
    from bitmapperbs_tpu_torch.models import graphs as device_graphs
    from bitmapperbs_tpu_torch.models.host import (map_batch_pe,
                                                   prepare_batch, to_host)
    from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device
    from bitmapperbs_tpu_torch.ops import kernels

    device = dix.device
    cfg = AlignerConfig(max_errors=E, indels=True, read_len_bucket=BUCKET,
                        batch_size=PE_PAIRS, paired=True,
                        min_insert=MIN_INSERT, max_insert=MAX_INSERT)
    t0 = time.perf_counter()
    sims, main, pairs, quals, qnames, r0 = pe_inputs(idx)
    log(f"PE inputs: {len(sims)} x {PE_PAIRS} simulated pairs in "
        f"{time.perf_counter() - t0:.2f} s")

    def to_dev(batch):
        a1, l1 = prepare_batch([p[0] for p in batch], BUCKET, PE_PAIRS)
        a2, l2 = prepare_batch([p[1] for p in batch], BUCKET, PE_PAIRS)
        return ([torch.from_numpy(x).to(device) for x in (a1, l1, a2, l2)],
                int(l1.min()), int(l2.min()))

    # ---- phase 8: PE main path ----------------------------------------------
    reset_launches()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    recs = map_batch_pe(idx, dix, cfg, pairs, quals, qnames, graphs=False)
    main_launches = dict(kernels.LAUNCHES)
    log(f"PE main path: {len(pairs)} pairs mapped in "
        f"{time.perf_counter() - t0:.2f} s (first call, eager), launches "
        f"{main_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    assert len(recs) == 2 * len(pairs)
    for name in ("verify_fused_gather", "rescue_scan", "myers", "fm_search",
                 "fm_locate", "pair_join", *FLAT_KERNELS):
        assert main_launches[name] > 0, f"{name} never ran on the PE path"
    lines = [r.line() for r in recs]
    t0 = time.perf_counter()
    grecs, replays, live = graph_path(
        "pe_10mbp_graph", dix,
        lambda: map_batch_pe(idx, dix, cfg, pairs, quals, qnames))
    assert [r.line() for r in grecs] == lines, \
        "PE records through CUDA graphs differ from the eager run's"
    log(f"PE main path through CUDA graphs: {len(pairs)} pairs in "
        f"{time.perf_counter() - t0:.2f} s (captures included), {replays} "
        f"replays of {len(live)} graph(s), records equal to the eager run's; "
        f"the replays launched {GRAPH_PATHS['pe_10mbp_graph']}")
    n = len(pairs)
    for lo, hi in ((0, N_PE_ORACLE), (r0, r0 + N_PE_ORACLE_RESCUE),
                   (n - N_PE_ORACLE_LOWCX, n)):
        oracle = [r.line() for r in oracle_pe(idx, cfg, pairs[lo:hi],
                                              quals[lo:hi], qnames[lo:hi])]
        bad = [i for i, (a, b) in enumerate(zip(oracle, lines[2 * lo:2 * hi]))
               if a != b]
        assert len(oracle) == 2 * (hi - lo) and not bad, \
            f"PE oracle mismatch at record {2 * lo + bad[0]}:\n" \
            f"{oracle[bad[0]]}\n{lines[2 * lo + bad[0]]}"
    proper = sum(bool(r.flag & K.FLAG_PROPER) for r in recs[::2]) / n
    sim_mates = [s for p in main for s in p]
    log(f"PE main path: SAM of pairs [0, {N_PE_ORACLE}), [{r0}, "
        f"{r0 + N_PE_ORACLE_RESCUE}) (seed-killed mate 2) and the last "
        f"{N_PE_ORACLE_LOWCX} (low-complexity, gdrop re-run) equals the "
        f"oracle; proper-pair rate {proper:.4f}, recall of the simulated "
        f"mates {recall(idx, sim_mates, recs[:2 * len(main)]):.4f}")

    # how the last batch's pairs were decided (outside the counted run)
    lo = (N_PE_MAIN_BATCHES - 1) * PE_PAIRS
    args, mn1, mn2 = to_dev(pairs[lo:])
    host = to_host(map_batch_pe_device(dix, cfg, *args, min_read_len1=mn1,
                                       min_read_len2=mn2))
    pv, rv, gd = host["pair_valid"], host["resc_valid"], host["gdrop"]
    for name, sl in (("ordinary", slice(0, r0 - lo)),
                     ("seed-killed", slice(r0 - lo, n - N_PE_LOWCX - lo)),
                     ("low-complexity", slice(n - N_PE_LOWCX - lo, n - lo))):
        log(f"PE decisions, last batch, {name} pairs: pair join "
            f"{int(pv[sl].sum())}, rescue {int((rv & ~pv)[sl].sum())}, "
            f"neither {int((~rv & ~pv)[sl].sum())} (compact pass; gdrop "
            f"{int(gd[sl].sum())})")

    # ---- phase 8b: rescue deciding: mates inside a repeat ---------------------
    rep_idx = build_index(tandem_genome_fasta(31))
    rep_dix = upload_index(rep_idx, device)
    rep = straddling_pairs(rep_idx, N_REPEAT_PAIRS, seed=32,
                           read_len=READ_LEN)
    reset_launches()
    rep_recs = [r.line() for r in map_batch_pe(rep_idx, rep_dix, cfg, rep)]
    rep_launches = dict(kernels.LAUNCHES)
    assert rep_launches["rescue_scan"] > 0, "rescue_scan never ran (repeat)"
    assert rep_recs == [r.line() for r in oracle_pe(rep_idx, cfg, rep)], \
        "repeat-genome PE SAM differs from the oracle"
    args, mn1, mn2 = to_dev(rep)
    host = to_host(map_batch_pe_device(rep_dix, cfg, *args,
                                       min_read_len1=mn1, min_read_len2=mn2))
    decided = int((host["resc_valid"] & ~host["pair_valid"])[:len(rep)].sum())
    assert 2 * decided >= len(rep), f"rescue decided only {decided} pairs"
    log(f"PE rescue in a repeat: {len(rep)} pairs with one mate inside a "
        f"20 bp x 200 tandem repeat; rescue decided {decided}, SAM equal to "
        f"the oracle; launches {rep_launches}")

    # ---- phase 9: PE gdrop dense fallback forced for a whole batch ----------
    reset_launches()
    torch.cuda.reset_peak_memory_stats(device)
    recs_g = map_batch_pe(idx, dix, cfg.replace(locate_flat_cap=1),
                          pairs[:PE_PAIRS], quals[:PE_PAIRS],
                          qnames[:PE_PAIRS], graphs=False)
    gdrop_launches = dict(kernels.LAUNCHES)
    assert gdrop_launches["myers"] > 0, "Myers kernel never ran (forced)"
    assert [r.line() for r in recs_g] == lines[:2 * PE_PAIRS], \
        "PE gdrop SAM differs"
    log(f"PE forced gdrop: {PE_PAIRS} pairs re-run dense, SAM equal to "
        f"phase 8; launches {gdrop_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")

    # ---- phase 10: PE CLI ---------------------------------------------------
    fq = [os.path.join(workdir, f"pairs_{k}.fq") for k in (1, 2)]
    for k in (0, 1):
        write_fastq(fq[k], [p[k] for p in pairs], qnames,
                    [q[k] for q in quals])
    out = os.path.join(workdir, "out_pe.sam")
    t0 = time.perf_counter()
    cli_run(["--pe", "--seq1", fq[0], "--seq2", fq[1], "-o", out,
             "--read-bucket", str(BUCKET), "--batch-size", str(PE_PAIRS),
             "--min", str(MIN_INSERT), "--max", str(MAX_INSERT),
             "-t", str(CLI_THREADS)], prefix)
    wall = time.perf_counter() - t0
    cli = sam_records(out)
    assert cli == lines, "PE CLI records differ from map_batch_pe's"
    log(f"PE CLI (--pe -t {CLI_THREADS}): {len(cli)} records equal to "
        f"phase 8 ({wall:.2f} s incl. start-up)")

    # ---- phase 11: PE throughput --------------------------------------------
    dev_batches = [to_dev([(a.codes, b.codes) for a, b in sb]) for sb in sims]

    def run_dev(batch):
        args, mn1, mn2 = batch
        return map_batch_pe_device(dix, cfg, *args, min_read_len1=mn1,
                                   min_read_len2=mn2)

    run_dev(dev_batches[0])["pair_sum"].cpu()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    outs = [run_dev(b) for b in dev_batches]
    for o in outs:
        o["pair_sum"].cpu()
    dev_rps = 2 * len(dev_batches) * PE_PAIRS / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    del outs
    e2e_rps, e2e_lo, e2e_hi, recs = host_rates(
        lambda: map_batch_pe(idx, dix, cfg, pairs, quals, qnames),
        2 * len(pairs))
    assert [r.line() for r in recs] == lines
    log(f"PE throughput: map_batch_pe_device {dev_rps:.1f} reads/s "
        f"({dev_rps / 2:.1f} pairs/s) over {len(dev_batches)} simulated "
        f"batches of {PE_PAIRS} pairs (peak device memory {peak:.2f} GB); "
        f"end-to-end map_batch_pe {e2e_rps:.1f} reads/s (median of "
        f"{E2E_REPS} runs, {e2e_lo:.1f}-{e2e_hi:.1f}) over phase 8's "
        f"{N_PE_MAIN_BATCHES} batches (one gdrop re-run), on {card}")

    # ---- CUDA graphs against eager on phase 8's batches ---------------------
    batches = host_batches(pairs, BUCKET, PE_PAIRS, pe=True)
    graphs_vs_eager("10 Mbp PE, phase 8's batches", dix, cfg, batches, True)
    graph_walls("10 Mbp PE", dix, cfg, batches, True, card)
    phase_flat_kernels({"10 Mbp PE, phase 8's last batch": capture_flat_args(
        lambda: eager_call(dix, cfg, batches[-1], True))}, {}, card)
    device_graphs.clear(dix)
    return main_launches, gdrop_launches, {
        "fq": fq, "lines": lines, "recs": recs, "pairs": pairs,
        "quals": quals, "qnames": qnames, "r0": r0, "cfg": cfg,
        "cli_s": wall}


def kill_once_cursor_advances(args, prefix: str, out: str,
                              at_record: int) -> dict:
    """Starts cli_cmd in a session of its own, SIGKILLs the session (the CLI
    and its finalize workers) once `<out>.cursor` has reached at_record,
    and returns the cursor it left."""
    import signal

    cursor = out + ".cursor"
    proc = subprocess.Popen(cli_cmd(args, prefix), cwd=ROOT,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, start_new_session=True)
    deadline = time.perf_counter() + 600
    try:
        while True:
            if os.path.exists(cursor):
                with open(cursor) as f:      # replaced whole, never torn
                    if json.load(f)["record"] >= at_record:
                        break
            if proc.poll() is not None:
                raise RuntimeError("CLI ended before its cursor advanced:\n"
                                   + proc.stderr.read().decode()[-4000:])
            assert time.perf_counter() < deadline, "no cursor in 600 s"
            time.sleep(0.05)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        proc.stderr.close()
    with open(cursor) as f:
        cur = json.load(f)
    assert set(cur) == {"record", "offset", "offset2", "out_pos"}, cur
    return cur


def trace_kernels(trace_dir: str) -> dict:
    """Kernel events of the Chrome trace(s) torch.profiler wrote into
    trace_dir: {kernel name: count}."""
    counts: dict = {}
    names = [n for n in os.listdir(trace_dir) if n.endswith(".json")]
    assert names, f"no trace in {trace_dir}"
    for name in names:
        with open(os.path.join(trace_dir, name)) as f:
            trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        for ev in events:
            if ev.get("cat") == "kernel":
                counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    return counts


def run_cli_extras(idx, dix, prefix: str, workdir: str, se: dict,
                   pe: dict) -> tuple[dict, dict, dict]:
    """Phase 11b on the 10 Mbp index: --resume after a SIGKILL (SE SAM, PE
    BAM with -t 2; the resumed PE run, one batch, with --profile), two hosts
    on the one card (--dist-hosts 2, gloo on 127.0.0.1, bytes then records),
    then PE at insert 0-100,000, which takes the rescue kernel's two passes
    (a batch on this genome, phase 8b's pairs in a tandem repeat).  Returns
    the launch counts of the last two, the two passes' times on the
    batch's own rescue_scan arguments (two_pass_record), and the wide-insert
    batch's configuration, records, wall and peak device memory, which
    phase 11c maps again on the sharded mesh."""
    import ast
    import socket

    import torch

    from bitmapperbs_tpu_torch import constants as K
    from bitmapperbs_tpu_torch.index.build import build_index
    from bitmapperbs_tpu_torch.index.device import upload_index
    from bitmapperbs_tpu_torch.io.bam import BamWriter
    from bitmapperbs_tpu_torch.models import graphs as device_graphs
    from bitmapperbs_tpu_torch.models.host import (map_batch_pe,
                                                   prepare_batch, to_host)
    from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device
    from bitmapperbs_tpu_torch.oracle.paired import map_batch_pe as oracle_pe
    from bitmapperbs_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    se_args = ["--seq", se["fq"], "--read-bucket", str(BUCKET),
               "--batch-size", str(BATCH)]
    pe_args = ["--pe", "--seq1", pe["fq"][0], "--seq2", pe["fq"][1],
               "--read-bucket", str(BUCKET), "--batch-size", str(PE_PAIRS),
               "--min", str(MIN_INSERT), "--max", str(MAX_INSERT)]

    # ---- resume: SE SAM, one batch per cursor ---------------------------------
    # killed once three of the four batches are acknowledged, so the resumed
    # run maps the last batch alone
    t0 = time.perf_counter()
    out = os.path.join(workdir, "resume.sam")
    cur = kill_once_cursor_advances([*se_args, "-o", out], prefix, out,
                                    3 * BATCH)
    assert cur["record"] < len(se["lines"]), cur
    cli_run([*se_args, "-o", out, "--resume"], prefix)
    assert not os.path.exists(out + ".cursor"), "cursor left after the run"
    assert sam_records(out) == se["lines"], "resumed SE records differ"
    log(f"resume, SE: killed with the cursor at record {cur['record']} "
        f"(output byte {cur['out_pos']}), resumed: {len(se['lines'])} "
        f"records equal to phase 6, cursor gone "
        f"({time.perf_counter() - t0:.2f} s for both runs)")

    # ---- resume: PE BAM with the finalize pool; the resumed run profiled --
    t0 = time.perf_counter()
    out = os.path.join(workdir, "resume.bam")
    cur = kill_once_cursor_advances([*pe_args, "-o", out, "-t", "2"], prefix,
                                    out, 3 * PE_PAIRS)
    assert cur["record"] < len(pe["pairs"]) and cur["offset2"] > 0, cur
    prof = os.path.join(workdir, "profile")
    err = cli_run([*pe_args, "-o", out, "-t", "2", "--resume", "--profile",
                   prof], prefix)
    assert not os.path.exists(out + ".cursor"), "cursor left after the run"
    buf = io.BytesIO()
    want = BamWriter(buf, idx.genome.names, idx.genome.lengths)
    for rec in pe["recs"]:
        want.write(rec)
    want.close()
    with open(out, "rb") as f:
        assert bam_record_bytes(f.read()) == bam_record_bytes(
            buf.getvalue()), "resumed PE BAM records differ from phase 10's"
    log(f"resume, PE BAM (-t 2): killed with the cursor at pair "
        f"{cur['record']}, resumed: the decompressed records equal phase "
        f"10's ({len(pe['lines'])}), cursor gone "
        f"({time.perf_counter() - t0:.2f} s for both runs)")

    # ---- profile: the resumed run, one PE batch ---------------------------------
    assert "profiler trace ->" in err, err[-2000:]
    kern = trace_kernels(prof)
    seen = {}
    for name in ("verify_fused_gather", "fm_search", "fm_locate",
                 "rescue_scan"):
        seen[name] = sum(c for k, c in kern.items() if name + "_kernel" in k)
        assert seen[name] > 0, f"no {name} kernel in the trace: {kern}"
    log(f"profile: the resumed run's one PE batch ({PE_PAIRS} pairs): Chrome "
        f"trace with {sum(kern.values())} kernel events; the port's kernels "
        f"among them: {seen}")

    # ---- two hosts on the one card -----------------------------------------------
    for mode in ("bytes", "records"):
        t0 = time.perf_counter()
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        out = os.path.join(workdir, f"hosts_{mode}.sam")
        procs = [subprocess.Popen(
            cli_cmd([*se_args, "-o", out, "--dist-hosts", "2",
                     "--dist-host-id", str(h), "--dist-shard", mode,
                     "--dist-coordinator", f"127.0.0.1:{port}"], prefix),
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True) for h in (0, 1)]
        errs = []
        try:
            for proc in procs:
                errs.append(proc.communicate(timeout=600)[1])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
        for proc, err in zip(procs, errs):
            if proc.returncode != 0:
                raise RuntimeError(f"host run ({mode}) failed "
                                   f"({proc.returncode}):\n{err[-4000:]}")
        shards = [sam_records(os.path.join(workdir, f"hosts_{mode}.shard{h}"
                                                    ".sam")) for h in (0, 1)]
        assert sorted(shards[0] + shards[1]) == sorted(se["lines"]), \
            f"the two shards ({mode}) differ from phase 6's records"
        msg = ""
        if mode == "records":
            for err in errs:
                line = [ln for ln in err.splitlines()
                        if "global (all 2 hosts)" in ln]
                assert len(line) == 1, err[-2000:]
                g = ast.literal_eval(line[0].split("hosts): ", 1)[1])
                assert g == {k: se["stats"][k] for k in g}, (g, se["stats"])
            msg = f"; global counters on both hosts equal phase 6's: {g}"
        log(f"two hosts on one card ({mode}): shards of {len(shards[0])} + "
            f"{len(shards[1])} records, together phase 6's{msg} "
            f"({time.perf_counter() - t0:.2f} s)")

    # ---- mate rescue past the one-pass limit: a PE batch at insert 0-100,000
    # on this genome, and phase 8b's pairs in a tandem repeat, where rescue
    # decides
    cfg = pe["cfg"].replace(max_insert=WIDE_PE_MAX_INSERT)
    R = cfg.max_insert - cfg.min_insert + 1
    assert kernels.rescue_scan_chunks(BUCKET, E, R) == (32, True)
    lo = (N_PE_MAIN_BATCHES - 1) * PE_PAIRS
    pairs, quals, qnames = (pe[k][lo:] for k in ("pairs", "quals", "qnames"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launches()
    recs = map_batch_pe(idx, dix, cfg, pairs, quals, qnames, graphs=False)
    launches = dict(kernels.LAUNCHES)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    assert launches["rescue_scan"] >= 2 and launches["rescue_scan"] % 2 == 0, \
        launches
    lines = [r.line() for r in recs]
    n, r0 = len(pairs), pe["r0"] - lo
    for a, b in ((0, N_PE_ORACLE), (r0, r0 + N_PE_ORACLE_RESCUE),
                 (n - N_PE_ORACLE_LOWCX, n)):
        oracle = [r.line() for r in oracle_pe(idx, cfg, pairs[a:b],
                                              quals[a:b], qnames[a:b])]
        bad = [i for i, (x, y) in enumerate(zip(oracle, lines[2 * a:2 * b]))
               if x != y]
        assert len(oracle) == 2 * (b - a) and not bad, \
            f"wide-insert PE oracle mismatch at record {2 * a + bad[0]}:\n" \
            f"{oracle[bad[0]]}\n{lines[2 * a + bad[0]]}"
    a1, l1 = prepare_batch([p[0] for p in pairs], BUCKET, PE_PAIRS)
    a2, l2 = prepare_batch([p[1] for p in pairs], BUCKET, PE_PAIRS)
    # this device call's rescue_scan arguments: both passes are timed on
    # them below, at the shape the path gives the kernel
    saved, calls = kernels.rescue_scan, []

    def recording(*a):
        calls.append(a)
        return saved(*a)
    kernels.rescue_scan = recording
    try:
        host = to_host(map_batch_pe_device(
            dix, cfg, *(torch.from_numpy(x).to(dix.device)
                        for x in (a1, l1, a2, l2)),
            min_read_len1=int(l1.min()), min_read_len2=int(l2.min())))
    finally:
        kernels.rescue_scan = saved
    assert len(calls) == 1, len(calls)
    args = calls[0]
    batch_tp = two_pass_record(
        args, kernels.rescue_scan(*args), args[3].cpu().numpy(),
        args[5].cpu().numpy(), BUCKET, R)
    log(f"rescue_scan's two passes on this batch's {batch_tp['pairs']} lanes "
        f"({batch_tp['pairs_with_a_hit']} with a hit) x {R + BUCKET + 2 * E} "
        f"columns: pass 1 {fmt_ms(batch_tp['pass1_device_ms'])} ms inside "
        f"(bound {batch_tp['pass1_bound_ms']:.4f}), pass 2 "
        f"{fmt_ms(batch_tp['pass2_device_ms'])} ms inside (bound "
        f"{batch_tp['pass2_bound_ms']:.4f}), call {batch_tp['ms']:.4f} ms; "
        f"the function's bound {batch_tp['bound_ms']:.4f} ms by "
        f"{batch_tp['bound_by']} ({batch_tp['columns_needed']} columns)")
    pv, rv = host["pair_valid"][:n], host["resc_valid"][:n]
    proper = sum(bool(r.flag & K.FLAG_PROPER) for r in recs[::2]) / n
    log(f"PE batch at insert {cfg.min_insert}-{cfg.max_insert} ({R} offsets:"
        f" the rescue kernel's two passes, 32 threads per pair): {n} pairs in "
        f"{wall:.2f} s, launches {launches}; SAM of pairs [0, {N_PE_ORACLE}),"
        f" [{r0}, {r0 + N_PE_ORACLE_RESCUE}) and the last "
        f"{N_PE_ORACLE_LOWCX} equals the oracle; pair join "
        f"{int(pv.sum())}, rescue {int((rv & ~pv).sum())}, neither "
        f"{int((~rv & ~pv).sum())}; proper-pair rate {proper:.4f}")
    # the same batch through its CUDA graph (both rescue passes inside it),
    # and phase 8's batches at this insert range three in flight
    grecs, replays, _ = graph_path(
        "pe_10mbp_insert_100k_graph", dix,
        lambda: map_batch_pe(idx, dix, cfg, pairs, quals, qnames))
    assert [r.line() for r in grecs] == lines, \
        "wide-insert PE records through a CUDA graph differ from eager's"
    assert GRAPH_PATHS["pe_10mbp_insert_100k_graph"]["rescue_scan"] == \
        2 * replays, GRAPH_PATHS
    graphs_vs_eager(f"10 Mbp PE at insert {cfg.min_insert}-"
                    f"{cfg.max_insert} (two rescue passes in the graph), "
                    f"phase 8's first three batches", dix, cfg,
                    host_batches(pe["pairs"][:3 * PE_PAIRS], BUCKET,
                                 PE_PAIRS, pe=True), True)
    device_graphs.clear(dix)
    rep_idx = build_index(tandem_genome_fasta(31))
    rep_dix = upload_index(rep_idx, dix.device)
    rep = straddling_pairs(rep_idx, N_REPEAT_PAIRS, seed=32,
                           read_len=READ_LEN)
    reset_launches()
    rep_lines = [r.line() for r in map_batch_pe(rep_idx, rep_dix, cfg, rep)]
    for k, v in kernels.LAUNCHES.items():
        launches[k] += v
    assert rep_lines == [r.line() for r in oracle_pe(rep_idx, cfg, rep)], \
        "repeat-genome PE SAM at insert 0-100,000 differs from the oracle"
    a1, l1 = prepare_batch([p[0] for p in rep], BUCKET, len(rep))
    a2, l2 = prepare_batch([p[1] for p in rep], BUCKET, len(rep))
    host = to_host(map_batch_pe_device(
        rep_dix, cfg, *(torch.from_numpy(x).to(dix.device)
                        for x in (a1, l1, a2, l2)),
        min_read_len1=int(l1.min()), min_read_len2=int(l2.min())))
    decided = int((host["resc_valid"] & ~host["pair_valid"])[:len(rep)].sum())
    assert 2 * decided >= len(rep), f"rescue decided only {decided} pairs"
    log(f"PE in a tandem repeat at insert {cfg.min_insert}-{cfg.max_insert} "
        f"(the windows span the whole {rep_idx.genome.length} bp genome): "
        f"rescue decided {decided} of {len(rep)} pairs in the two passes, SAM"
        f" equal to the oracle")
    log(f"phase 11b: {time.perf_counter() - t_phase:.2f} s")
    wide = {"cfg": cfg, "start": lo, "lines": lines, "peak_bytes": peak,
            "wall_s": wall}
    return launches, batch_tp, wide


def phase_shard_gather_kernel(sdix) -> dict:
    """gather_rows_shard vs its plain version on each shard of a 2-shard
    index of the 10 Mbp genome (phase 11c's), at the lanes that phase 11c's
    data slices of BATCH // 2 reads hand it: genome planes W = 3 at [flat
    lanes, 5] (the window gather of the dense re-run, the record's
    headline), checkpoint rows W = 17 at a search step's 2 x reads x frames
    x seeds lanes and SA samples W = 1 at the flat buffer's lanes (ragged),
    which the FM kernels now fetch themselves: the tables a sharded index
    splits (the k-mer table stays whole).  Lanes sit on both sides of every
    shard boundary, in the per-block padding rows, below 0 and past the
    end; the shards' partial rows, summed, are the whole table's rows."""
    import torch

    from bitmapperbs_tpu_torch.index.device import Shards
    from bitmapperbs_tpu_torch.ops import kernels

    dev = sdix.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    reads = BATCH // 2
    flat = reads * 10
    headline = "g_planes W=3"
    cases = (          # name, shards, lane shape, global padding rows
        ("cp_rows W=17, search step lanes", sdix.cp_rows,
         (2 * reads * 2 * 5,),
         (sdix.rows_max - 1, 2 * sdix.rows_max - 1)),
        ("sa_samples W=1, ragged", Shards(tuple(
            p[:, None] for p in sdix.sa_samples.parts)), (flat - 3,),
         (sdix.samples_max - 1, 2 * sdix.samples_max - 1)),
        (headline, sdix.g_planes, (flat, 5),
         (2 * sdix.g_words - 1 + len(sdix.g_planes.parts) - 1,)),
    )
    shapes = {}
    for name, shards, shape, pad_rows in cases:
        rows, W = shards.parts[0].shape
        total = rows * len(shards.parts)
        ix = torch.randint(0, total, shape, device=dev, generator=gen,
                           dtype=torch.int64)
        flat_ix = ix.view(-1)
        edges = [b + d for b in range(0, total + 1, rows) for d in (-1, 0)]
        edges += [r for r in pad_rows if r < total] + [-7, total + 11]
        flat_ix[:len(edges)] = torch.tensor(edges, device=dev)
        summed = torch.zeros((*shape, W), dtype=torch.int32, device=dev)
        for k, part in enumerate(shards.parts):
            want = kernels.gather_rows_shard_ref(part, ix, k * rows)
            got = kernels.gather_rows_shard(part, ix, k * rows)
            torch.cuda.synchronize()
            assert got.shape == want.shape == (*shape, W)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"gather_rows_shard {name}, shard {k}: kernel != plain "
                    f"on {int((got != want).sum())} words")
            summed += got
        whole = torch.cat(shards.parts)
        inside = (ix >= 0) & (ix < total)
        assert torch.equal(summed[inside], whole[ix[inside]]), name
        assert not summed[~inside].any(), name
        assert torch.equal(kernels.gather_table(shards, ix), summed), name
        part, base = shards.parts[0], 0
        n_in = int(((ix >= 0) & (ix < rows)).sum())
        L = ix.numel()

        def kern():
            return kernels.gather_rows_shard(part, ix, base)

        def plain():
            return kernels.gather_rows_shard_ref(part, ix, base)

        ms, plain_ms = median_ms(kern), median_ms(plain)
        inside_ms = device_ms(kern, "gather_rows_kernel")
        # the index read, the rows of this shard's lanes read, every lane's
        # row written (a zero row for the others)
        b = bound(L * (8 + 4 * W) + n_in * 4 * W, 0)
        log(f"kernel gather_rows_shard, {name}: {L} lanes ({n_in} on shard "
            f"0 of {len(shards.parts)}, {rows} x {W} rows each), every "
            f"shard equal to plain and the partials summed equal to the "
            f"whole table's rows; shard 0: median {ms:.4f} ms "
            f"({fmt_ms(inside_ms)} inside the kernel) vs plain "
            f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']}; no single PyTorch call zeroes the rows of "
            f"other shards")
        shapes[name] = {"lanes": L, "lanes_on_shard": n_in, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": None, **b,
                         "device_ms": inside_ms}
    return {"max_abs_err": 0, **shapes[headline], "shapes": shapes}


def shard_edges(name: str, args: tuple) -> tuple:
    """plant_fm_edges' lanes with rows past the table planted as well: a
    search slice whose table interval and an extension whose interval end
    lie past every shard, where the SHARD fetch reads a zero row."""
    args = list(args)
    if name == "fm_search" and args[5] is not None:
        sp0, ep0 = args[5].clone(), args[6].clone()
        sp0.view(-1)[13::113] = 0xFFFF0000
        ep0.view(-1)[13::113] = 0xFFFFFF00
        args[5:7] = sp0, ep0
    elif name == "fm_extend":
        ep = args[5].clone()
        ep.view(-1)[11::109] = 0xFFFFFF00
        args[5] = ep
    return tuple(args)


def phase_shard_kernels(idx, dix, cfg, batch) -> dict:
    """Phase 3 addition: the SHARD instances of the fused kernels (a sharded
    index: each row read from the shard that holds it) vs their plain
    versions, torch.equal, on a 2-shard and a 3-shard upload of the 10 Mbp
    index on [cuda:0] x 2 / x 3, and vs the whole-table instance on the same
    lanes: fm_search / fm_extend / fm_locate on the arguments a sharded data
    slice of `batch` hands them (its reads, on the sharded index) with edge
    lanes planted (plant_fm_edges, and rows past the table);
    verify_fused_gather at m 96 (the headline lanes) and m 288;
    rescue_scan in one pass (insert 0-500) and in two (100,001 offsets).
    Each timed inside the kernel beside the whole-table instance on the same
    lanes and its bound (the SHARD instance's own instruction counts).
    Returns {kernel: {"2 shards": record, "3 shards": record}}."""
    import numpy as np
    import torch

    from bitmapperbs_tpu_torch.index.device import Shards, \
        upload_index_sharded
    from bitmapperbs_tpu_torch.ops import kernels, verify

    dev = dix.device
    out: dict = {}

    def record(name, ns, kern, whole, plain, b, extra="", plain_ms=None,
               graphs=False):
        ms = median_ms(kern)
        inside = device_ms(kern, name)
        whole_inside = device_ms(whole, name)
        if plain_ms is None:
            plain_ms = median_ms(plain, reps=PLAIN_FM_REPS)
        graph = {}
        if graphs:      # a second reading of both instances, no profiler
            graph = {"graph_ms": graph_ms(kern),
                     "whole_graph_ms": graph_ms(whole)}
            extra += (f"; CUDA graph of 20 launches: {graph['graph_ms']:.4f}"
                      f" ms per launch, the whole-table instance "
                      f"{graph['whole_graph_ms']:.4f}")
        log(f"kernel {name} on {ns} shards{extra}: equal to plain and to the "
            f"whole-table instance; median {ms:.4f} ms ({fmt_ms(inside)} "
            f"inside the kernel; the whole-table instance "
            f"{fmt_ms(whole_inside)} on the same lanes) vs plain "
            f"{plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']}")
        return {"ms": ms, "device_ms": inside,
                "whole_device_ms": whole_inside, "plain_ms": plain_ms, **b,
                **graph}

    def check(got, want, what):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: {int((g != w).sum())} of "
                                     f"{g.numel()} lanes differ")

    refs = {"fm_search": kernels.fm_search_ref,
            "fm_extend": kernels.fm_extend_ref,
            "fm_locate": kernels.fm_locate_ref}
    lane_bytes = {"fm_search": 5 * 8 + 2 * 8, "fm_extend": 4 * 8 + 3 * 8,
                  "fm_locate": 2 * 8 + 1 + 4 + 8}
    for ns in (2, 3):
        sdix = upload_index_sharded(idx, [dev] * ns)
        key = f"{ns} shards"
        # ---- the FM step kernels on a sharded data slice's own arguments
        calls = capture_fm_calls(sdix, cfg, batch)
        for name in FM_KERNELS:
            # fm_locate's lane count (a keyword) goes to both instances
            kern, (args, kw) = getattr(kernels, name), calls[name]
            planted = shard_edges(name, plant_fm_edges(sdix, name, args))
            check(kern(*planted), refs[name](*planted),
                  f"{name} on {ns} shards, edge lanes")
            check(kern(*args, **kw), refs[name](*args, **kw),
                  f"{name} on {ns} shards")
            whole = (dix,) + args[1:]
            check(kern(*args, **kw), kern(*whole, **kw),
                  f"{name} on {ns} shards vs the whole table")
            rows = torch.zeros(args[1].shape, dtype=torch.int32, device=dev)
            kern(*args, **kw, rows_out=rows)
            n_rows = int(rows.sum())
            steps = n_rows / (1 if name == "fm_locate" else 2)
            b = bound(n_rows * CP_ROW_BYTES + rows.numel() * lane_bytes[name]
                      + (steps if name != "fm_locate" else 0),
                      n_rows * FM_THREADS_PER_ROW
                      * SASS_OPS[name + " shard"]["loop"])
            out.setdefault(name, {})[key] = {
                **record(name, ns, lambda: kern(*args, **kw),
                         lambda: kern(*whole, **kw),
                         lambda: refs[name](*args, **kw), b,
                         f", {rows.numel()} lanes ({n_rows} rows)",
                         graphs=True),
                "lanes": rows.numel(), "rows_fetched": n_rows}
        # ---- the gathering verify, narrow (m 96) and wide (m 288) kernels,
        # timed; the wider buckets' builds held to plain
        for m, n in ((BUCKET, KERNEL_LANES), (LONG_BUCKET, 10_240),
                     *WIDE_SHARD_SHAPES):
            ncols, Wd = m + 2 * E, m // 32
            wide, rp, lm, _, _, lanes = kernel_inputs(
                idx, sdix, n, seed=7, m=m, read_len=m - 6)
            g_args = (sdix.g_planes, lanes["orient"], lanes["start"],
                      lanes["read_tab"], lanes["row"], lanes["lens"],
                      sdix.genome_len, sdix.g_words, m, ncols, E)
            w_args = (dix.g_planes,) + g_args[1:]
            got = kernels.verify_fused_gather(*g_args)
            check(got, kernels.verify_fused_gather_ref(*g_args),
                  f"verify_fused_gather m {m} on {ns} shards")
            check(got, kernels.verify_fused_gather(*w_args),
                  f"verify_fused_gather m {m} on {ns} shards vs whole")
            build = wide_build(Wd, shard=True)
            threads = (f"; {build['words']} words per thread, "
                       f"{build['threads']} threads per lane, "
                       f"{build['registers']} registers" if build else "")
            if (m, n) in WIDE_SHARD_SHAPES:
                log(f"kernel verify_fused_gather on {ns} shards, m {m}, {n} "
                    f"lanes{threads}: equal to plain and to the whole-table "
                    f"instance")
                continue
            ham = verify.hamming(verify.shift_planes(wide, E, Wd), rp, lm)
            n_myers = int((ham > E).sum())
            Ww = Wd + 1
            b = bound(n * (12 * (Ww + 1) + 4 * 8 + 8 * 3 * Wd + 4),
                      verify_ops("verify_fused_gather shard", n, n_myers,
                                 ncols, Wd))
            out.setdefault("verify_fused_gather", {})[f"{key}, m {m}"] = {
                **record("verify_fused_gather", ns,
                         lambda: kernels.verify_fused_gather(*g_args),
                         lambda: kernels.verify_fused_gather(*w_args),
                         lambda: kernels.verify_fused_gather_ref(*g_args), b,
                         f", m {m}, {n} lanes ({n_myers} run Myers){threads}",
                         graphs=True),
                "lanes": n, "m": m}
        # ---- mate rescue: one pass at insert 0-500, two at 100,001 offsets
        for R, n in ((MAX_INSERT - MIN_INSERT + 1, PE_PAIRS),
                     (WIDE_PE_MAX_INSERT + 1, 64)):
            chunks, two_pass = kernels.rescue_scan_chunks(BUCKET, E, R)
            assert two_pass == (R > 58_107)
            args, r_ok, span = rescue_inputs(idx, sdix, n, BUCKET, R)
            w_args = (dix.g_planes,) + args[1:]
            got = kernels.rescue_scan(*args)
            plain_ms = None
            if two_pass:
                # on copies on the host's CPU, as phase 3 runs this plain
                # version (a loop of ~30 small ops per column)
                t0 = time.perf_counter()
                cpu = Shards(tuple(p.cpu() for p in args[0].parts))
                with torch.inference_mode():
                    want = tuple(t.to(dev) for t in kernels.rescue_scan_ref(
                        cpu, *(a.cpu() if isinstance(a, torch.Tensor) else a
                               for a in args[1:])))
                plain_ms = (time.perf_counter() - t0) * 1e3
            else:
                want = kernels.rescue_scan_ref(*args)
            check(got, want, f"rescue_scan at {R} offsets on {ns} shards")
            check(got, kernels.rescue_scan(*w_args),
                  f"rescue_scan at {R} offsets on {ns} shards vs whole")
            Ww = -(-(R + BUCKET + 2 * E) // 32)
            nbytes = n * (41 + 40 * (BUCKET // 32) + 12 * (Ww + 1) + 16)
            needed = rescue_columns_run(r_ok, span, BUCKET, E, R, 1)
            if two_pass:
                hit = np.asarray(want[0].cpu()) <= E
                c1, c2 = (SASS_OPS[f"rescue_scan pass {k} shard"]
                          for k in (1, 2))
                ops = n * (c1["once"] + c2["once"]) + needed * c1["loop"] \
                    + rescue_columns_run(r_ok & hit, span, BUCKET, E, R,
                                         1) * c2["loop"]
            else:
                c = SASS_OPS["rescue_scan shard"]
                ops = n * c["once"] + needed * c["loop"]
            b = bound(nbytes, ops)
            out.setdefault("rescue_scan", {})[
                f"{key}, {R} offsets" + (", two passes" if two_pass
                                         else "")] = {
                **record("rescue_scan", ns,
                         lambda: kernels.rescue_scan(*args),
                         lambda: kernels.rescue_scan(*w_args),
                         lambda: kernels.rescue_scan_ref(*args), b,
                         f", {n} pairs at {R} offsets ({chunks} threads per "
                         f"pair{', two passes' if two_pass else ''}; "
                         f"{needed} columns needed)", plain_ms),
                "pairs": n, "insert_range": R, "two_pass": two_pass}
        del sdix
    return out


def run_mesh(idx, dix, card: str, se: dict, pe: dict, wide: dict):
    """Phase 11c on the 10 Mbp index: the multi-card paths with one card
    standing for the mesh (a device may appear more than once).  First the
    sharded-index kernels against their plain versions (phase 3 additions:
    gather_rows_shard, and the SHARD instances of the fused kernels).  Data
    parallel on [cuda:0] x 2 (the index replicated): phase 4's reads and
    phase 8's pairs.  Sharded index on [cuda:0] x 4 with --shard-index 2
    (2 data slices, the index split over 2 shards each): phase 4's 4th
    batch and phase 8's 4th batch, phase 8b's tandem-repeat pairs for
    rescue deciding, and phase 11b's wide-insert batch (`wide`, insert
    0-100,000: rescue in two passes).  Returns gather_rows_shard's record,
    the launch counts of the five main paths, each counted from 0 over its
    own run, and the SHARD instances' records (phase_shard_kernels)."""
    import torch

    from bitmapperbs_tpu_torch.index.build import build_index
    from bitmapperbs_tpu_torch.index.device import upload_index_sharded
    from bitmapperbs_tpu_torch.models.host import map_batch, map_batch_pe, \
        prepare_batch, to_host
    from bitmapperbs_tpu_torch.oracle.paired import map_batch_pe as oracle_pe
    from bitmapperbs_tpu_torch.ops import kernels
    from bitmapperbs_tpu_torch.parallel.shard import make_cli_mappers

    t_phase = time.perf_counter()
    dev = dix.device
    cfg, pe_cfg = se["cfg"], pe["cfg"]
    lo = (N_MAIN_BATCHES - 1) * BATCH
    plo = (N_PE_MAIN_BATCHES - 1) * PE_PAIRS

    # one card eager, as the mesh's data slices are: the walls below compare
    # the meshes, not the CUDA graphs
    def se_run(mappers, lo):
        return map_batch(idx, None if mappers else dix, cfg, se["reads"][lo:],
                         se["quals"][lo:], se["qnames"][lo:], mappers=mappers,
                         graphs=False)

    def pe_run(mappers, lo):
        return map_batch_pe(idx, None if mappers else dix, pe_cfg,
                            pe["pairs"][lo:], pe["quals"][lo:],
                            pe["qnames"][lo:], mappers=mappers, graphs=False)

    # ---- phase 3 additions: the row-range gather on a 2-shard index, the
    # fused kernels' SHARD instances on 2- and 3-shard ones, the FM kernels
    # on a data slice of phase 4's last batch
    sdix = upload_index_sharded(idx, [dev] * 2)
    kstat = phase_shard_gather_kernel(sdix)
    del sdix
    half = BATCH // 2
    a, ln = prepare_batch(se["reads"][lo:lo + half], BUCKET, half)
    # seed extension on (as the Gbp configuration sets it), so that the
    # slice launches fm_extend as well
    shard_stats = phase_shard_kernels(
        idx, dix, cfg.replace(batch_size=half, seed_ext_max=20),
        (torch.from_numpy(a).to(dev), torch.from_numpy(ln).to(dev),
         int(ln.min())))

    dp = {"se": make_cli_mappers(idx, cfg, [dev] * 2)}
    dp["pe"] = make_cli_mappers(idx, pe_cfg, reuse=dp["se"])
    sh = {"se": make_cli_mappers(idx, cfg, [dev] * 4, shard_index=2)}
    sh["pe"] = make_cli_mappers(idx, pe_cfg, reuse=sh["se"])
    assert dp["se"].mesh.shape == {"data": 2}, dp["se"].mesh.shape
    assert sh["se"].mesh.shape == {"data": 2, "idx": 2}, sh["se"].mesh.shape
    sd = sh["se"].dix[0]
    parts = {name: [p.numel() * 4 for p in getattr(sd, name).parts]
             for name in ("cp_rows", "sa_samples", "g_planes")}
    whole = {name: getattr(dix, name).numel() * 4 for name in parts}
    log("mesh, sharded index: per shard " + "; ".join(
        f"{name} {parts[name][0] / 1e6:.3f} MB x {len(parts[name])} "
        f"(replicated {whole[name] / 1e6:.3f} MB)" for name in parts)
        + f"; whole on the group's first card: cbase, n, klt "
        f"{sd.klt.numel() * 4 / 1e6:.3f} MB; one upload for both data "
        f"slices: {sd.cp_rows.parts[0] is sh['se'].dix[1].cp_rows.parts[0]}")

    def wide_run(mappers, lo):
        return map_batch_pe(idx, None if mappers else dix, wide["cfg"],
                            pe["pairs"][lo:], pe["quals"][lo:],
                            pe["qnames"][lo:], mappers=mappers, graphs=False)

    # ---- the five main paths, each checked against its phase's records ----
    sh["wide"] = make_cli_mappers(idx, wide["cfg"], reuse=sh["se"])
    paths = (   # key, what, mappers, run, start, records to equal
        ("se_10mbp_mesh_dp", "data parallel, phase 4's reads", dp["se"],
         se_run, 0, se["lines"]),
        ("pe_10mbp_mesh_dp", "data parallel, phase 8's pairs", dp["pe"],
         pe_run, 0, pe["lines"]),
        ("se_10mbp_sharded", "sharded index, phase 4's last batch (its "
         f"{N_LOWCX} low-complexity reads take the dense re-run)", sh["se"],
         se_run, lo, se["lines"][lo:]),
        ("pe_10mbp_sharded", "sharded index, phase 8's last batch (its "
         f"{N_PE_RESCUE} seed-killed mates take rescue, its {N_PE_LOWCX} "
         "low-complexity pairs the dense re-run)", sh["pe"], pe_run, plo,
         pe["lines"][2 * plo:]),
        ("pe_10mbp_sharded_insert_100k", "sharded index, phase 11b's "
         f"wide-insert batch (insert {wide['cfg'].min_insert}-"
         f"{wide['cfg'].max_insert}: rescue in two passes)", sh["wide"],
         wide_run, wide["start"], wide["lines"]),
    )
    launches, walls = {}, {}
    for key, what, mappers, run, start, want in paths:
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = [r.line() for r in run(mappers, start)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches[key] = dict(kernels.LAUNCHES)
        assert got == want, f"mesh {key}: records differ from the " \
            f"single-card run's"
        extra = ""
        if key == "pe_10mbp_sharded_insert_100k":
            extra = (f"; peak device memory {peak / 1e9:.3f} GB (one card "
                     f"in phase 11b: {wide['peak_bytes'] / 1e9:.3f} GB, "
                     f"{wide['wall_s']:.2f} s)")
        log(f"mesh, {what}, {mappers.mesh.shape} on [cuda:0] x "
            f"{sum(map(len, mappers.mesh.devices))}: {len(got)} records "
            f"in {wall:.2f} s synced (first call; {card}), equal to the "
            f"single-card run's; launches {launches[key]}{extra}")

    # ---- per-batch walls: one card's pipeline beside the mesh's, in turns
    # (the host's dispatch and finalize move these walls by up to 2x from
    # run to run, so the three meshes take turns within each round)
    for kind, run, start in (("SE", se_run, lo), ("PE", pe_run, plo)):
        meshes = {"one card": None, "data parallel x 2": dp[kind.lower()],
                  "sharded 2 x 2": sh[kind.lower()]}
        ts = {name: [] for name in meshes}
        for _ in range(MESH_WALL_ROUNDS):
            for name, m in meshes.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(m, start)
                torch.cuda.synchronize()
                ts[name].append(time.perf_counter() - t0)
        for name, t in ts.items():
            walls[f"{kind} {name}"] = (statistics.median(t), min(t), max(t))
    log("mesh, per-batch wall of the last batch (" + f"{BATCH} reads / "
        f"{PE_PAIRS} pairs, map_batch / map_batch_pe end to end, synced, "
        f"median and range of {MESH_WALL_ROUNDS} rounds in turns; {card}): "
        + "; ".join(f"{k} {v[0] * 1e3:.1f} ms ({v[1] * 1e3:.1f}-"
                    f"{v[2] * 1e3:.1f})" for k, v in walls.items()))

    # ---- rescue deciding on the sharded index: tandem-repeat pairs ---------
    rep_idx = build_index(tandem_genome_fasta(31))
    rep = straddling_pairs(rep_idx, N_REPEAT_PAIRS, seed=32,
                           read_len=READ_LEN)
    rsh = make_cli_mappers(rep_idx, pe_cfg, [dev] * 4, shard_index=2)
    rep_lines = [r.line() for r in map_batch_pe(rep_idx, None, pe_cfg, rep,
                                                mappers=rsh)]
    assert rep_lines == [r.line() for r in oracle_pe(rep_idx, pe_cfg, rep)], \
        "sharded tandem-repeat PE SAM differs from the oracle"
    a1, l1 = prepare_batch([p[0] for p in rep], BUCKET, len(rep))
    a2, l2 = prepare_batch([p[1] for p in rep], BUCKET, len(rep))
    host = to_host(rsh.pe(a1, l1, a2, l2, int(l1.min()), int(l2.min())))
    decided = int((host["resc_valid"] & ~host["pair_valid"]).sum())
    assert decided == len(rep), f"rescue decided {decided} of {len(rep)}"
    log(f"mesh, sharded index: {len(rep)} tandem-repeat pairs, SAM equal "
        f"to the oracle, rescue decided {decided} of {len(rep)}")

    # ---- what the paths launch: on a sharded index what one card launches
    # (the FM step kernels, the gathering verify, mate rescue), and the
    # row-range gather only for the dense re-run's windows (with myers)
    for key in ("se_10mbp_mesh_dp", "pe_10mbp_mesh_dp"):
        assert launches[key]["gather_rows_shard"] == 0, launches[key]
    fused = ("fm_search", "fm_locate", "verify_fused_gather")
    for key, want in (("se_10mbp_sharded", fused + ("gather_rows_shard",
                                                    "myers")),
                      ("pe_10mbp_sharded", fused + ("rescue_scan",
                                                    "gather_rows_shard",
                                                    "myers")),
                      ("pe_10mbp_sharded_insert_100k",
                       fused + ("rescue_scan",))):
        for k in want:
            assert launches[key][k] > 0, f"{key}: {k} never launched"
    assert launches["pe_10mbp_sharded_insert_100k"]["rescue_scan"] % 2 == 0
    log(f"phase 11c: {time.perf_counter() - t_phase:.2f} s")
    return kstat, launches, shard_stats


def phase_gather_kernel(dix, flat_lanes: int) -> dict:
    """gather_rows vs its plain version and vs torch.index_select on the
    Gbp-configuration index's own tables.  The record carries the k-mer
    table lookup, the shape the compact path launches once per candidate
    stage; the other shapes (the window gather of the dense and paired-end
    paths, and the checkpoint-row and SA-sample fetches that the FM kernels
    now make themselves) are checked and timed beside it."""
    import torch

    from bitmapperbs_tpu_torch.ops import kernels

    dev = dix.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    headline = "klt W=2"
    cases = (          # name, table, lane shape
        (headline, dix.klt, (GBP_BATCH, 2, 5)),
        ("cp_rows W=17, seed lanes", dix.cp_rows, (GATHER_LANES,)),
        ("cp_rows W=17, flat lanes", dix.cp_rows, (flat_lanes,)),
        ("sa_samples W=1, ragged", dix.sa_samples[:, None], (flat_lanes - 3,)),
        ("g_planes W=3", dix.g_planes, (flat_lanes, 5)),
    )
    out = None
    for name, table, shape in cases:
        R, W = table.shape
        sets = []
        for _ in range(GATHER_SETS):
            ix = torch.randint(0, R, shape, device=dev, generator=gen,
                               dtype=torch.int64)
            flat = ix.view(-1)
            flat[::97] = -1 - flat[::97]              # below 0
            flat[1::89] = R + flat[1::89]             # at / past the end
            flat[0], flat[-1] = R, -1
            sets.append(ix)
        for ix in sets[:2]:
            want = kernels.gather_rows_ref(table, ix)
            got = kernels.gather_rows(table, ix)
            torch.cuda.synchronize()
            assert got.shape == want.shape == (*shape, W)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"gather_rows {name}: kernel != plain on "
                    f"{int((got != want).sum())} words")
        turn = [0]

        def rotating(fn):
            def call():
                turn[0] += 1
                return fn(sets[turn[0] % GATHER_SETS])
            return call

        def kern(ix):
            return kernels.gather_rows(table, ix)

        def plain(ix):
            return kernels.gather_rows_ref(table, ix)

        def library(ix):
            return torch.index_select(table, 0, ix.view(-1).clamp(0, R - 1))

        ms, plain_ms, lib_ms = (median_ms(rotating(f))
                                for f in (kern, plain, library))
        inside = device_ms(rotating(kern), "gather_rows")
        plain_dev = device_ms(rotating(plain))
        lib_dev = device_ms(rotating(library))
        L = sets[0].numel()
        b = bound(L * (8 + 8 * W), 0)      # index, row in, row out
        log(f"kernel gather_rows, {name}: {L} lanes of a {R} x {W} table "
            f"({R * W * 4 / 1e6:.1f} MB) equal to plain, out-of-range indices"
            f" clamped; median {ms:.4f} ms ({fmt_ms(inside)} inside the "
            f"kernel) vs plain {plain_ms:.4f} ms ({fmt_ms(plain_dev)} inside "
            f"its kernels) vs index_select {lib_ms:.4f} ms ({fmt_ms(lib_dev)} "
            f"inside its kernels, the clamp included); bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']}")
        shape_rec = {"lanes": L, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, **b, "device_ms": inside,
                     "plain_device_ms": plain_dev,
                     "library_device_ms": lib_dev}
        if name == headline:
            out = {"max_abs_err": 0, **shape_rec, "shapes": {}}
        out["shapes"][name] = shape_rec
    return out


def capture_fm_calls(dix, cfg, batch) -> dict:
    """The arguments that one map_batch_device call hands to fm_search,
    fm_extend and fm_locate: (positional, keyword) each (fm_locate's lane
    count n_lanes is a keyword)."""
    from bitmapperbs_tpu_torch.models.aligner import map_batch_device
    from bitmapperbs_tpu_torch.ops import kernels

    saved = {name: getattr(kernels, name) for name in FM_KERNELS}
    calls = {}

    def recording(name):
        def call(*args, **kw):
            calls[name] = (args, kw)
            return saved[name](*args, **kw)
        return call

    try:
        for name in FM_KERNELS:
            setattr(kernels, name, recording(name))
        a, ln, mn = batch
        map_batch_device(dix, cfg, a, ln, min_read_len=mn)["best_score"].cpu()
    finally:
        for name in FM_KERNELS:
            setattr(kernels, name, saved[name])
    assert set(calls) == set(FM_KERNELS), set(calls)
    return calls


def plant_fm_edges(dix, name: str, args: tuple) -> tuple:
    """Copies of a captured call's lane tensors with edge lanes planted."""
    import torch

    def own(x):
        return x.contiguous().clone()

    if name == "fm_search":
        d, blk, pat, st, en, sp0, ep0, k, max_len = args[:9]
        st, en, sp0, ep0 = own(st), own(en), own(sp0), own(ep0)
        en.view(-1)[3::101] = st.view(-1)[3::101]          # empty slices
        en.view(-1)[5::103] = st.view(-1)[5::103] + 3      # shorter than klt_k
        ep0.view(-1)[7::107] = sp0.view(-1)[7::107]        # empty from the table
        st.view(-1)[11::109] = 0                           # longer than max_len
        # min_len 0: the plain version must walk the short slices
        return (d, blk, pat, st, en, sp0, ep0, k, max_len, 0)
    if name == "fm_extend":
        d, blk, pat, st, sp, ep, ext_max, ext_occ = args
        st, sp, ep = own(st), own(sp), own(ep)
        st.view(-1)[3::101] = 0                            # at the read start
        ep.view(-1)[5::103] = sp.view(-1)[5::103]          # empty interval
        ep.view(-1)[7::107] = (sp.view(-1)[7::107] - 1).clamp(min=0)  # ep < sp
        return (d, blk, pat, st, sp, ep, ext_max, ext_occ)
    d, blk, i, valid = args
    blk, i, valid = own(blk), own(i), own(valid)
    i.view(-1)[3::101] = d.n[blk.view(-1)[3::101]] + 5     # past the text
    i.view(-1)[5::103] = 0xFFFFFFFF
    valid.view(-1)[3::101] = True
    valid.view(-1)[5::103] = True
    valid.view(-1)[7::107] = False
    return (d, blk, i, valid)


def phase_fm_kernels(dix, cfg, small, big) -> dict:
    """fm_search / fm_extend / fm_locate vs their lockstep plain versions on
    the arguments real batches give them (`small`: batches of 4,096 reads,
    `big`: of 16,384), edge lanes planted; times with the calls rotating
    through the batches."""
    import torch

    from bitmapperbs_tpu_torch.ops import kernels

    seed = [0]

    def chase_ms(table, evict: bool) -> float:
        """ms per dependent load on `table`, median of 5 chains, a new chain
        each time; evict: overwrite the L2 before each chain, so that its
        loads come from device memory."""
        times = []
        for _ in range(5):
            seed[0] += 1
            if evict:
                torch.empty(L2_EVICT_BYTES, dtype=torch.int8,
                            device=dix.device).fill_(1)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            kernels.dependent_load_chain(table, CHASE_STEPS, seed[0] * 7919)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times) / CHASE_STEPS

    words = dix.cp_rows.view(-1)
    probe = chase_ms(words, evict=True)
    in_l2 = words[:L2_RESIDENT_BYTES // 4]
    in_l2.sum()                                    # brings the slice in
    probe_l2 = chase_ms(in_l2, evict=False)
    log(f"dependent-load latency on the {words.numel() * 4 / 1e6:.1f} MB "
        f"checkpoint table: {probe * 1e6:.1f} ns with the L2 overwritten "
        f"before each chain, {probe_l2 * 1e6:.1f} ns on its first "
        f"{L2_RESIDENT_BYTES / 1e6:.0f} MB kept in the L2 (one thread, "
        f"{CHASE_STEPS} loads, each address from the word before)")
    refs = {"fm_search": kernels.fm_search_ref,
            "fm_extend": kernels.fm_extend_ref,
            "fm_locate": kernels.fm_locate_ref}
    # bytes per lane beside the rows: int64 inputs, outputs (and the bool
    # and the SA sample in locate); one pattern byte per step
    lane_bytes = {"fm_search": 5 * 8 + 2 * 8, "fm_extend": 4 * 8 + 3 * 8,
                  "fm_locate": 2 * 8 + 1 + 4 + 8}
    rows_per_step = {"fm_search": 2, "fm_extend": 2, "fm_locate": 1}
    out = {}
    for label, batches in (("4,096", small), ("16,384", big)):
        calls = [capture_fm_calls(
            dix, cfg.replace(batch_size=b[0].shape[0]), b) for b in batches]
        for name in FM_KERNELS:
            kern = getattr(kernels, name)
            sets = [c[name] for c in calls]
            planted = plant_fm_edges(dix, name, sets[0][0])
            lanes = planted[1].shape
            as_tuple = (lambda r: r if isinstance(r, tuple) else (r,))
            err = 0
            checks = [(planted, {}), sets[-1]]
            if name == "fm_locate":
                # the flat buffer's fill as the path hands it (the lanes
                # past it write 0 and load nothing), and planted counts
                n = lanes[0]
                checks += [(planted, {"n_lanes": torch.tensor(
                    [c], dtype=torch.int64, device=dix.device)})
                    for c in (0, n // 3, n + 7)]
                n_used = [int(kw["n_lanes"]) for _, kw in sets]
            for args, kw in checks:
                want = as_tuple(refs[name](*args, **kw))
                rows = torch.full(lanes, -1, dtype=torch.int32,
                                  device=dix.device)
                got = as_tuple(kern(*args, **kw, rows_out=rows))
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert g.shape == w.shape == lanes, (g.shape, w.shape)
                    err = max(err, int((g - w).abs().max()))
                    if not torch.equal(g, w):
                        raise AssertionError(
                            f"{name} ({label} per batch): kernel != plain on "
                            f"{int((g != w).sum())} lanes")
                assert int(rows.min()) >= 0
            # the rows this data makes the kernel fetch, over the rotation
            n_rows, longest = 0, 0
            for args, kw in sets:
                rows = torch.zeros(lanes, dtype=torch.int32,
                                   device=dix.device)
                kern(*args, **kw, rows_out=rows)
                n_rows += int(rows.sum())
                longest = max(longest, int(rows.max()))
            n_rows /= len(sets)
            L = rows.numel()
            steps = n_rows / rows_per_step[name]
            # locate's lanes past the fill write their 8 bytes and no more
            live = statistics.mean(min(n, L) for n in n_used) \
                if name == "fm_locate" else L
            other = live * lane_bytes[name] + (L - live) * 8 \
                + (steps if name != "fm_locate" else 0)
            b = bound(n_rows * CP_ROW_BYTES + other,
                      n_rows * FM_THREADS_PER_ROW * SASS_OPS[name]["loop"])
            # what the card moves for those rows: whole 32-byte sectors
            sector_ms = (n_rows * CP_ROW_SECTORS[name] * 32 + other) \
                / HBM_BYTES_PER_S * 1e3
            # dependent loads of the slowest lane: its inputs, one row per
            # step, and in locate the SA sample
            chain = 1 + longest // rows_per_step[name] \
                + (name == "fm_locate")
            turn = [0]

            def rotating(fn):
                def call():
                    turn[0] += 1
                    args, kw = sets[turn[0] % len(sets)]
                    return fn(*args, **kw)
                return call

            ms = median_ms(rotating(kern))      # as the main path calls it
            plain_ms = median_ms(rotating(refs[name]), reps=PLAIN_FM_REPS)
            inside = device_ms(rotating(kern), name + "_kernel")
            fill = (f", the flat buffer's fill {statistics.mean(n_used):.0f} "
                    f"lanes on average (lane counts 0, {L // 3} and {L + 7} "
                    f"planted too)" if name == "fm_locate" else "")
            log(f"kernel {name}, {label} reads per batch: {L} lanes equal to "
                f"plain, planted edge lanes included (max_abs_err {err}"
                f"{fill}); "
                f"median {ms:.4f} ms on the main path's arguments "
                f"({fmt_ms(inside)} inside the kernel) vs plain "
                f"{plain_ms:.3f} ms; {n_rows:.0f} rows fetched per call "
                f"({n_rows / L:.2f} per lane, at most {longest}); bound "
                f"{b['bound_ms']:.4f} ms by {b['bound_by']} at "
                f"{CP_ROW_BYTES} bytes per row ({sector_ms:.4f} ms counting "
                f"the {CP_ROW_SECTORS[name]} sectors of 32 bytes a row's "
                f"words span); latency floor {chain * probe:.4f} ms "
                f"({chain} dependent loads)")
            shape = {"lanes": L, "ms": ms, "plain_ms": plain_ms, **b,
                     "device_ms": inside, "rows_fetched": n_rows,
                     "sector_bytes_ms": sector_ms,
                     "latency_floor_ms": chain * probe}
            if name == "fm_locate":
                shape["lanes_filled"] = statistics.mean(n_used)
            if name not in out:             # the record carries the 4,096 shape
                out[name] = {"max_abs_err": err, **shape, "library_ms": None,
                             "dependent_load_ns": probe * 1e6,
                             "dependent_load_in_l2_ns": probe_l2 * 1e6,
                             "shapes": {}}
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            out[name]["shapes"][f"{label} reads per batch"] = shape
        del calls
    return out


def satellite_reads(idx, n: int, seed: int):
    """n bisulfite reads from inside the genome's mid-copy satellite arrays
    (tandem tilings of a SAT_PERIOD-bp unit with SAT_COPIES copies): every
    seed of such a read recurs once per copy, few enough to pass
    max_seed_occ and too regular for seed extension to thin out, so the
    read fills hundreds of flat-buffer slots.  The arrays are found from
    the sequence itself: windows where the text equals itself shifted by
    the period."""
    import numpy as np

    from bitmapperbs_tpu_torch import constants as K
    from bitmapperbs_tpu_torch.utils import dna

    g = np.asarray(idx.genome.codes)
    p, w = SAT_PERIOD, SAT_WINDOW
    nwin = (len(g) - p) // w
    same = (g[:nwin * w] == g[p:p + nwin * w]) & (g[:nwin * w] < 4)
    hot = same.reshape(nwin, w).mean(axis=1) >= 0.9
    edges = np.flatnonzero(np.diff(np.concatenate([[0], hot, [0]])))
    spans = [(a * w, b * w) for a, b in zip(edges[::2], edges[1::2])
             if SAT_COPIES[0] * p <= (b - a) * w <= SAT_COPIES[1] * p]
    if not spans:
        raise RuntimeError("no mid-copy satellite array found in the genome")
    rng = np.random.default_rng(seed)
    reads = []
    for k in rng.integers(0, len(spans), n):
        a, b = spans[k]
        s = int(rng.integers(a, b - READ_LEN))
        frag = g[s:s + READ_LEN].copy()
        if rng.integers(0, 2):
            frag = dna.revcomp(frag)                       # OB
        frag[(frag == K.C) & (rng.random(READ_LEN) < 0.7)] = K.T
        reads.append(frag)
    return reads, len(spans)


def timed_stages(stages: dict, run_batch, batches):
    """Per-stage ms per batch of run_batch(batch) (median over the batches):
    each function named in `stages` ({label: (module, attribute)}) is
    wrapped with a device sync on both sides, so launch overhead is charged
    to its stage; a stage called several times per batch sums its calls.
    Returns ({label: ms}, ms of the whole batch); `rest` is the batch less
    the stages."""
    import torch

    spent = {name: [] for name in stages}       # ms, one entry per batch
    saved = {name: getattr(mod, attr) for name, (mod, attr) in stages.items()}

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name][-1] += 1e3 * (time.perf_counter() - t0)
            return out
        return call

    totals = []
    try:
        for name, (mod, attr) in stages.items():
            setattr(mod, attr, timed(name, saved[name]))
        for batch in batches:
            for per_batch in spent.values():
                per_batch.append(0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_batch(batch)
            totals.append(1e3 * (time.perf_counter() - t0))
    finally:
        for name, (mod, attr) in stages.items():
            setattr(mod, attr, saved[name])
    table = {name: statistics.median(ms) for name, ms in spent.items()}
    table["rest"] = statistics.median(
        t - sum(ms[i] for ms in spent.values()) for i, t in enumerate(totals))
    return table, statistics.median(totals)


def stage_table(dix, cfg, batches) -> tuple[dict, float]:
    """The stage table of map_batch_device; `rest` is what runs between the
    stages and is still plain PyTorch: conversion, frame stack, rolling
    k-mers, seed bounds and the read planes, and the anchor mask and sort
    keys."""
    import torch

    from bitmapperbs_tpu_torch.models import aligner
    from bitmapperbs_tpu_torch.ops import fm, kernels

    stages = {"seed (KLT + backward search)": (fm, "search_patterns"),
              "extend seeds": (fm, "extend_seeds"),
              "flat expand (one kernel)": (kernels, "flat_expand"),
              "locate": (fm, "locate"),
              "sort (torch.sort)": (torch, "sort"),
              "dedup (one kernel)": (kernels, "flat_dedup"),
              "window gather + verify (one kernel)":
                  (kernels, "verify_fused_gather"),
              "scatter back (one kernel)": (kernels, "scatter_back"),
              "select (one kernel)": (kernels, "select_se")}

    def run_batch(batch):
        a, ln, mn = batch
        aligner.map_batch_device(dix, cfg, a, ln,
                                 min_read_len=mn)["best_score"].cpu()

    return timed_stages(stages, run_batch, batches)


def pe_stage_table(dix, cfg, batches) -> tuple[dict, float]:
    """The stage table of map_batch_pe_device; `rest` is the anchored-mate
    choice, the missing mate's tables and the window bounds."""
    from bitmapperbs_tpu_torch.models import paired
    from bitmapperbs_tpu_torch.ops import kernels

    # the two candidate stages are one function called twice per batch
    # (mate 1, then mate 2): each call is sent to a stage of its own
    saved = paired.candidate_stage
    mates = types.SimpleNamespace(calls=0, stage1=saved, stage2=saved)

    def by_mate(*a, **kw):
        mates.calls += 1
        return (mates.stage1 if mates.calls % 2 else mates.stage2)(*a, **kw)

    stages = {"candidate stage, mate 1": (mates, "stage1"),
              "candidate stage, mate 2": (mates, "stage2"),
              "pair join": (kernels, "pair_join"),
              "select (both mates, one kernel each)": (kernels, "select_se"),
              "rescue (one rescue_scan launch)": (paired, "_rescue_scan")}

    def run_batch(batch):
        args, m1, m2 = batch
        paired.map_batch_pe_device(dix, cfg, *args, min_read_len1=m1,
                                   min_read_len2=m2)["pair_sum"].cpu()

    paired.candidate_stage = by_mate
    try:
        return timed_stages(stages, run_batch, batches)
    finally:
        paired.candidate_stage = saved


def idle_share(run_batches, n_walls: int = 5) -> dict:
    """Device idle share of run_batches() (which must end synced): walls of
    n_walls unprofiled runs first, then one run under torch.profiler, whose
    device-kernel rows give the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(n_walls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_batches()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_batches()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    kernels_n = sum(e.count for e in rows)
    out = {"walls_ms": walls, "busy_ms": busy, "device_kernels": kernels_n}
    if busy > 0:
        out["idle"] = (1 - busy / min(walls), 1 - busy / max(walls))
    return out


def pair_join_bytes(B: int, F1: int, F2: int, Kc: int) -> int:
    """The bytes the pair join must move: every slot's score (int32) and
    anchor (int64) of both mates read once, the two lengths (int64) read
    once, the nine outputs (three int32, six int64) written once."""
    return B * (F1 + F2) * Kc * 12 + B * 2 * 8 + B * (3 * 4 + 6 * 8)


def leaves(out: dict, path: str = ""):
    """(dotted key, tensor) of every leaf of a device call's output dict."""
    for k, v in out.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{path}{k}.")
        else:
            yield path + k, v


def eager_call(dix, cfg, batch: tuple, pe: bool):
    """The eager device call on a host batch: SE (reads, lengths,
    min_read_len), PE (a1, l1, a2, l2, min_read_len1, min_read_len2)."""
    import torch

    from bitmapperbs_tpu_torch.models.aligner import map_batch_device
    from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device

    t = [torch.from_numpy(x).to(dix.device) for x in batch[:4 if pe else 2]]
    if pe:
        return map_batch_pe_device(dix, cfg, *t, min_read_len1=batch[4],
                                   min_read_len2=batch[5])
    return map_batch_device(dix, cfg, *t, min_read_len=batch[2])


def graph_call(dix, cfg, batch: tuple, pe: bool):
    """The same call replayed from its CUDA graph (models/graphs.py)."""
    from bitmapperbs_tpu_torch.models import graphs

    return (graphs.map_batch_pe if pe else graphs.map_batch)(dix, cfg, *batch)


def host_batches(items, m_pad: int, rows: int, pe: bool) -> list:
    """Host batches (graph_call's form) of `rows` reads or pairs each."""
    from bitmapperbs_tpu_torch.models.host import prepare_batch

    out = []
    for lo in range(0, len(items), rows):
        chunk = items[lo:lo + rows]
        if pe:
            a1, l1 = prepare_batch([p[0] for p in chunk], m_pad, rows)
            a2, l2 = prepare_batch([p[1] for p in chunk], m_pad, rows)
            out.append((a1, l1, a2, l2, int(l1.min()), int(l2.min())))
        else:
            a, ln = prepare_batch(chunk, m_pad, rows)
            out.append((a, ln, int(ln.min())))
    return out


def graph_path(name: str, dix, run):
    """run() (a map_batch / map_batch_pe call on dix with its graphs on)
    with dix's graphs cleared first: records under GRAPH_PATHS[name] each
    graph's replays times the launches its capture counted, summed per
    kernel, and returns (run()'s records, the replays, the graphs).  That
    product is computed, not counted: a replay counts nothing in Python.
    The launches that the same run made eagerly (its tail batches, a gdrop
    dense re-run) are not in it.  Fails if no graph replayed."""
    from bitmapperbs_tpu_torch.models import graphs
    from bitmapperbs_tpu_torch.ops import kernels

    graphs.clear(dix)
    recs = run()
    live = [g for _, g in graphs.graphs(dix)]
    launched = dict.fromkeys(kernels.LAUNCHES, 0)
    for g in live:
        for k, v in g.launches.items():
            launched[k] += v * g.replays
    replays = sum(g.replays for g in live)
    assert replays > 0 and sum(launched.values()) > 0, \
        f"{name}: no CUDA graph replayed"
    GRAPH_PATHS[name] = launched
    return recs, replays, live


def no_host_sync(label: str, dix, cfg, batch: tuple, pe: bool) -> None:
    """The eager device call of a host batch (graph_call's form), its inputs
    already on the card and the call warmed up once, run again under
    torch.cuda.set_sync_debug_mode("error"): a host sync anywhere inside it
    (a read of a device value, a blocking copy) raises.  Once per
    configuration and mode (SYNC_CHECKED)."""
    import torch

    from bitmapperbs_tpu_torch.models.aligner import map_batch_device
    from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device

    if (cfg, pe) in SYNC_CHECKED:
        return
    t = [torch.from_numpy(x).to(dix.device) for x in batch[:4 if pe else 2]]

    def call():
        if pe:
            return map_batch_pe_device(dix, cfg, *t, min_read_len1=batch[4],
                                       min_read_len2=batch[5])
        return map_batch_device(dix, cfg, *t, min_read_len=batch[2])

    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    SYNC_CHECKED.add((cfg, pe))
    log(f"no host sync, {label}: the eager device call ({len(out)} outputs, "
        f"flat_chunks {cfg.flat_chunks}) ran under "
        f"torch.cuda.set_sync_debug_mode('error')")


def graphs_vs_eager(label: str, dix, cfg, batches: list, pe: bool) -> None:
    """Every batch dispatched through its graph before the first is read
    (at least three in flight), then every output leaf held to the eager
    device call's on the same batch (torch.equal); the first batch's eager
    call run once with no host sync allowed (no_host_sync)."""
    import torch

    assert len(batches) >= 3
    no_host_sync(label, dix, cfg, batches[0], pe)
    outs = [graph_call(dix, cfg, b, pe) for b in batches]
    for i, (b, out) in enumerate(zip(batches, outs)):
        want = dict(leaves(eager_call(dix, cfg, b, pe)))
        got = dict(leaves(out))
        assert got.keys() == want.keys(), (sorted(got), sorted(want))
        bad = [k for k, v in want.items() if not torch.equal(got[k], v)]
        assert not bad, f"{label}: graph != eager in batch {i}: {bad}"
    log(f"graphs vs eager, {label}: {len(batches)} batches dispatched "
        f"through their graphs before the first was read; all {len(want)} "
        f"output leaves of each equal to the eager call's (torch.equal)")


def graph_walls(label: str, dix, cfg, batches: list, pe: bool,
                card: str) -> dict:
    """Synced per-batch walls of the eager device call and of its graph
    replay, both from the same host arrays, GRAPH_ROUNDS rounds taken in
    turns (eager first in even rounds, the graph in odd ones); the device
    idle share of each over the batches; every live graph's warm-up and
    capture seconds and its pool's bytes."""
    import torch

    from bitmapperbs_tpu_torch.models import graphs

    no_host_sync(label, dix, cfg, batches[0], pe)
    sync = "pair_sum" if pe else "best_score"
    runs = {"eager": lambda b: eager_call(dix, cfg, b, pe),
            "graph": lambda b: graph_call(dix, cfg, b, pe)}
    for fn in runs.values():            # the graphs captured, all warm
        for b in batches:
            fn(b)[sync].cpu()
    walls = {name: [] for name in runs}
    for r in range(GRAPH_ROUNDS):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                runs[name](b)[sync].cpu()
            walls[name].append(1e3 * (time.perf_counter() - t0)
                               / len(batches))
    out = {}
    for name, fn in runs.items():
        def all_batches(fn=fn):
            for b in batches:
                fn(b)
            torch.cuda.synchronize()
        idle = idle_share(all_batches)
        w = walls[name]
        out[name] = {"wall_ms": (statistics.median(w), min(w), max(w)),
                     "idle": idle.get("idle"),
                     "busy_ms": idle["busy_ms"] / len(batches),
                     "device_kernels": idle["device_kernels"] / len(batches)}
    live = [(key, g) for key, g in graphs.graphs(dix) if key[0] == cfg]
    out["graphs"] = [{"capture_s": g.capture_s, "warmup_s": g.warmup_s,
                      "pool_bytes": g.pool_bytes, "replays": g.replays}
                     for _, g in live]
    log(f"eager vs CUDA graph, {label}, synced per-batch wall over "
        f"{len(batches)} batches, median and range of {GRAPH_ROUNDS} rounds "
        f"in turns; {card}: " + "; ".join(
            f"{name} {v['wall_ms'][0]:.3f} ms ({v['wall_ms'][1]:.3f}-"
            f"{v['wall_ms'][2]:.3f}), device idle share "
            + ("{:.2f}-{:.2f}".format(*v["idle"]) if v["idle"]
               else "not measured (the profiler reported no device time)")
            + f", {v['busy_ms']:.3f} ms of device time and "
            f"{v['device_kernels']:.1f} device kernels per batch"
            for name, v in out.items() if name != "graphs")
        + "; graphs: " + "; ".join(
            f"capture {g['capture_s']:.3f} s (warm-up {g['warmup_s']:.3f} s),"
            f" pool {g['pool_bytes'] / 1e6:.1f} MB, {g['replays']} replays"
            for g in out["graphs"]))
    return out


def trimmed_lengths(rng, n: int, keep: float):
    """Lengths of n trimmed reads (the model of TRIM_KEEPS)."""
    import numpy as np

    cut = rng.integers(TRIM_MIN, TRIM_READ_LEN, n)
    return np.where(rng.random(n) < keep, TRIM_READ_LEN, cut)


def trimmed_keys(cfg, lens1, lens2=None, rate=None) -> tuple[int, float]:
    """From lengths only (nothing mapped): the number of graph keys
    (models/graphs.graph_key) of the full batches that the CLI's search
    makes of reads (lens1) or pairs (lens1, lens2) of these lengths, and
    the share of them that full batches hold.  As the CLI at --threads 1:
    chunks of GBP_BATCH reads, each split into groups by cli._cfg_key
    (error budget, bucket; a pair by the larger of its mates'), each group
    into batches of cfg.batch_size, of which only the full ones replay a
    graph."""
    import numpy as np

    from bitmapperbs_tpu_torch import cli
    from bitmapperbs_tpu_torch.models import graphs

    table = np.array([cli._cfg_key(cfg, rate, n)
                      for n in range(int(lens1.max()) + 1)])
    k = table[lens1]
    if lens2 is not None:
        k = np.maximum(k, table[lens2])
    keys, in_full, bs = set(), 0, cfg.batch_size
    for lo in range(0, len(lens1), GBP_BATCH):
        kc = k[lo:lo + GBP_BATCH]
        for b, bk in np.unique(kc, axis=0):
            sel = lo + np.flatnonzero((kc[:, 0] == b) & (kc[:, 1] == bk))
            c = cfg.replace(max_errors=int(b), read_len_bucket=int(bk))
            for s in range(0, len(sel) - bs + 1, bs):
                rows = sel[s:s + bs]
                mins = [int(x[rows].min()) for x in (lens1, lens2)
                        if x is not None]
                keys.add(graphs.graph_key(c, bs, int(bk), *mins))
                in_full += bs
    return len(keys), in_full / len(lens1)


def phase_trimmed(idx, dix, cfg, pcfg, card: str) -> dict:
    """Phase 13b (see the module docstring): trimmed reads and pairs mapped
    with their graphs and eager, and the length-only key counts."""
    import numpy as np

    from bitmapperbs_tpu_torch.models import graphs
    from bitmapperbs_tpu_torch.models.host import map_batch, map_batch_pe
    from bitmapperbs_tpu_torch.utils.simulate import (simulate_pairs,
                                                      simulate_reads_bulk)

    n = N_TRIM_BATCHES * GBP_BATCH
    rng = np.random.default_rng(170)
    keep = TRIM_KEEPS[0]
    codes = simulate_reads_bulk(idx.genome, n, TRIM_READ_LEN, seed=171)[0]
    reads = [codes[i, :ln] for i, ln in
             enumerate(trimmed_lengths(rng, n, keep))]
    psims = simulate_pairs(idx.genome, n, read_len=TRIM_READ_LEN, seed=172,
                           sub_rate=0.01, indel_rate=0.005, min_insert=200,
                           max_insert=480)
    l1, l2 = trimmed_lengths(rng, n, keep), trimmed_lengths(rng, n, keep)
    pairs = [(a.codes[:x], b.codes[:y]) for (a, b), x, y in
             zip(psims, l1, l2)]
    out = {}
    for label, c, items, fn, pe in (
            ("SE", cfg, reads, map_batch, False),
            ("PE", pcfg, pairs, map_batch_pe, True)):
        c = c.replace(read_len_bucket=TRIM_BUCKET)
        want = [r.line() for r in fn(idx, dix, c, items, graphs=False)]
        graphs.clear(dix)
        t0 = time.perf_counter()
        got = [r.line() for r in fn(idx, dix, c, items)]
        wall = time.perf_counter() - t0
        assert got == want, f"trimmed {label}: graph records != eager's"
        live = graphs.graphs(dix)
        assert live, f"trimmed {label}: no graph replayed"
        rec = {"keys": [list(key[3:]) for key, _ in live],
               "replays": [g.replays for _, g in live],
               "graph_run_s": wall}
        log(f"trimmed {label}: {len(items)} {'pairs' if pe else 'reads'} "
            f"(keep {keep}) through map_batch{'_pe' if pe else ''} with "
            f"graphs in {wall:.2f} s (captures included), records equal to "
            f"the eager run's; {len(live)} graph key(s), min_read_len // "
            f"num_seeds {rec['keys']}, replays {rec['replays']}")
        rec.update(graph_walls(f"trimmed {label}", dix, c, host_batches(
            items, TRIM_BUCKET, GBP_BATCH, pe), pe, card))
        graphs.clear(dix)
        out[label] = rec

    base = cfg.replace(read_len_bucket=TRIM_BUCKET)
    counts = {}
    for keep in TRIM_KEEPS:
        lens = [trimmed_lengths(rng, N_TRIM_COUNT, keep) for _ in range(2)]
        for e, rate in ((base.max_errors, None), (TRIM_RATE, TRIM_RATE)):
            for label, l2 in (("SE", None), ("PE", lens[1])):
                counts[f"keep {keep}, -e {e}, {label}"] = trimmed_keys(
                    base, lens[0], l2, rate)
    log(f"trimmed reads, from lengths only ({N_TRIM_COUNT} reads or pairs "
        f"each, the CLI's chunks of {GBP_BATCH} at --threads 1): graph keys "
        f"and the share of reads in graphed batches: " + "; ".join(
            f"{k}: {n} key(s), {share:.4f}"
            for k, (n, share) in counts.items()))
    out["length_only_keys"] = {k: list(v) for k, v in counts.items()}
    return out


def capture_pair_join_args(run) -> tuple:
    """The arguments that the one device call run() hands kernels.pair_join
    (the wrapper is restored after)."""
    from bitmapperbs_tpu_torch.ops import kernels

    seen, real = [], kernels.pair_join

    def spy(*a):
        seen.append(a)
        return real(*a)
    kernels.pair_join = spy
    try:
        run()
    finally:
        kernels.pair_join = real
    assert len(seen) == 1, len(seen)
    return seen[0]


def largest_tensor(run) -> int:
    """The most elements of any tensor a PyTorch operation made in run()
    (a dispatch mode sees every operation's outputs; the ctypes kernels
    are not operations, their outputs are made by torch.empty)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    most = [0]

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    most[0] = max(most[0], t.numel())
            return out

    with Watch():
        run()
    torch.cuda.synchronize()
    return most[0]


def phase_pair_join_kernel(dix, pcfg, pe_batches, card: str) -> dict:
    """The pair join kernel vs its plain version (torch.equal, all nine
    outputs): on the arguments that the Gbp PE batch's device call hands it
    (directional, Kc 128), the same batch mapped PBAT (4 frame pairs) and
    at Kc 256, and on seeded grids of 4,096 pairs with the edge rows of
    plant_pair_join_rows, directional at the cell's insert range and PBAT at
    100-300.  Each shape timed by a CUDA graph of 20 launches beside its
    bytes bound, with its cells of two valid candidates (all, and the
    fullest frame pair's); at the main path's shape also the call, inside
    (torch.profiler) and plain times, and the same arguments emptied and
    with one pair of Kc x Kc cells planted (what sets the time).  Then the
    PE device call with the plain join and with the kernel: peak device
    memory, and the most elements of any tensor made (no [B, Kc, Kc]
    tensor with the kernel)."""
    import torch

    from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device
    from bitmapperbs_tpu_torch.ops import kernels
    from bitmapperbs_tpu_torch.oracle.pipeline import se_frames

    dev = dix.device
    L = dix.genome_len
    (args, m1, m2) = pe_batches[0]

    def pe_call(c):
        return map_batch_pe_device(dix, c, *args, min_read_len1=m1,
                                   min_read_len2=m2)

    cases = {f"Gbp PE batch, directional, Kc {pcfg.max_candidates}":
             capture_pair_join_args(lambda: pe_call(pcfg)),
             f"Gbp PE batch, PBAT, Kc {pcfg.max_candidates}":
             capture_pair_join_args(
                 lambda: pe_call(pcfg.replace(non_directional=True))),
             f"Gbp PE batch, directional, Kc {WIDE_JOIN_KC}":
             capture_pair_join_args(
                 lambda: pe_call(pcfg.replace(max_candidates=WIDE_JOIN_KC)))}
    for pbat, (lo, hi) in ((False, (pcfg.min_insert, pcfg.max_insert)),
                           (True, (100, 300))):
        c = pcfg.replace(non_directional=pbat)
        f1s, f2s = tuple(se_frames(c, 0)), tuple(se_frames(c, 1))
        g = pair_join_grids(90 + pbat, GBP_BATCH, pcfg.max_candidates, f1s,
                            f2s, L, E, lo, hi)
        n = plant_pair_join_rows(g, f1s, f2s, L, E, lo, hi)
        t = {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
        cases[f"seeded grids + {n} edge rows, "
              f"{'PBAT' if pbat else 'directional'}, insert {lo}-{hi}"] = (
            t["s1"], t["f1"], t["s2"], t["f2"], f1s, f2s, t["m1"], t["m2"],
            L, E, lo, hi)
    flat = lambda r: [*r[0], *r[1:]]            # noqa: E731
    rec = {"shapes": {}}
    err = 0
    for label, a in cases.items():
        got = flat(kernels.pair_join(*a))
        want = flat(kernels.pair_join_ref(*a))
        torch.cuda.synchronize()
        bad = [i for i, (x, y) in enumerate(zip(got, want))
               if not torch.equal(x, y)]
        assert not bad, f"pair_join != plain on {label}: outputs {bad}"
        err = max(err, max(int((x.to(torch.int64) - y.to(torch.int64))
                               .abs().max()) for x, y in zip(got, want)))
        B, F1, Kc = a[0].shape
        F2 = a[2].shape[1]
        valid = int((want[0] < 2 * (1 << 20)).sum())
        n1, n2 = (a[0] < (1 << 20)).sum(-1), (a[2] < (1 << 20)).sum(-1)
        cells = sum(int((n1[:, i1] * n2[:, i2]).sum())
                    for i1, i2, *_ in kernels.frame_pairs(a[4], a[5]))
        inside = graph_ms(lambda a=a: kernels.pair_join(*a))
        most = max(int((n1[:, i1] * n2[:, i2]).max())
                   for i1, i2, *_ in kernels.frame_pairs(a[4], a[5]))
        b = bound(pair_join_bytes(B, F1, F2, Kc), 0)
        rec["shapes"][label] = {"pairs": B, "frames": (F1, F2), "kc": Kc,
                                "graph_ms": inside, **b,
                                "proper_pairs": valid, "cells": cells,
                                "most_cells_of_a_frame_pair": most}
        log(f"kernel pair_join, {label}: {B} pairs x ({F1} + {F2}) frames x "
            f"Kc {Kc}, all nine outputs equal to plain; {valid} proper "
            f"pairs, {cells} cells of two valid candidates over the "
            f"compatible frame pairs, {most} in the fullest; CUDA graph "
            f"{inside:.4f} ms per launch, bound {b['bound_ms']:.4f} ms by "
            f"bytes")
    a = next(iter(cases.values()))
    B, F1, Kc = a[0].shape
    ms = median_ms(lambda: kernels.pair_join(*a))
    inside = device_ms(lambda: kernels.pair_join(*a), "pair_join_kernel")
    plain = median_ms(lambda: kernels.pair_join_ref(*a), reps=PLAIN_JOIN_REPS)
    main = rec["shapes"][next(iter(cases))]
    graph = main["graph_ms"]
    rec.update(max_abs_err=err, ms=ms, plain_ms=plain, graph_ms=graph,
               device_ms=inside, bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=None)
    log(f"kernel pair_join at the main path's shape ({B} pairs, Kc {Kc}): "
        f"median {ms:.4f} ms per call ({fmt_ms(inside)} inside, "
        f"CUDA graph {graph:.4f}), plain {plain:.3f} ms; bound "
        f"{main['bound_ms']:.4f} ms by bytes; no single PyTorch call "
        f"computes it")
    # what sets its time: the same arguments with every slot emptied (the
    # work that does not depend on the data), and with one pair whose first
    # frame pair holds Kc x Kc ok cells planted in the emptied batch
    inf, inv = 1 << 20, 0xFFFFFFFF
    empty = [torch.full_like(a[0], inf), torch.full_like(a[1], inv),
             torch.full_like(a[2], inf), torch.full_like(a[3], inv)]
    heavy = [t.clone() for t in empty]
    i1, i2, *_ = kernels.frame_pairs(a[4], a[5])[0]
    ar = torch.arange(Kc, dtype=torch.int64, device=dev)
    heavy[0][0, i1], heavy[1][0, i1] = 1, 1_000_000 + ar
    heavy[2][0, i2], heavy[3][0, i2] = 1, 1_000_000 + ar + Kc
    tail = {}
    for name, grids in (("every slot empty", empty),
                        (f"one pair of {Kc} x {Kc} cells", heavy)):
        ja = (*grids, *a[4:])
        assert all(torch.equal(x, y) for x, y in zip(
            flat(kernels.pair_join(*ja)), flat(kernels.pair_join_ref(*ja))))
        tail[name] = graph_ms(lambda ja=ja: kernels.pair_join(*ja))
    rec["tail_graph_ms"] = tail
    log("kernel pair_join, what sets its time, CUDA graph ms per launch on "
        "the main path's arguments: " + "; ".join(
            f"{k} {v:.4f}" for k, v in tail.items())
        + f" (the batch as it is: {graph:.4f}); {card}")

    # the PE device call before and after: its peak device memory and its
    # largest tensor, with the plain join and with the kernel
    grid = B * Kc * Kc
    peaks = {}
    for name, join in (("plain join", kernels.pair_join_ref),
                       ("pair_join kernel", kernels.pair_join)):
        saved = kernels.pair_join
        kernels.pair_join = join
        try:
            pe_call(pcfg)["pair_sum"].cpu()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            pe_call(pcfg)["pair_sum"].cpu()
            peak = torch.cuda.max_memory_allocated(dev)
            most = largest_tensor(lambda: pe_call(pcfg))
        finally:
            kernels.pair_join = saved
        peaks[name] = {"peak_bytes": peak, "above_bytes": peak - base,
                       "largest_tensor": most}
    assert peaks["plain join"]["largest_tensor"] >= grid, peaks
    assert peaks["pair_join kernel"]["largest_tensor"] < grid, peaks
    rec["pe_call_memory"] = peaks
    log(f"Gbp PE device call ({B} pairs, Kc {Kc}), peak device memory: " +
        "; ".join(f"{name} {v['peak_bytes'] / 1e9:.3f} GB "
                  f"({v['above_bytes'] / 1e9:.3f} GB above the index and "
                  f"inputs), largest tensor {v['largest_tensor']:,} elements"
                  for name, v in peaks.items())
        + f" (a [B, Kc, Kc] grid: {grid:,}); {card}")
    return rec


def capture_flat_args(run) -> dict:
    """The arguments that run() (device calls on the card) hands the four
    flat-buffer wrappers: {kernel: [args of each call]}; the wrappers are
    restored after."""
    import torch

    from bitmapperbs_tpu_torch.ops import kernels

    saved = {name: getattr(kernels, name) for name in FLAT_KERNELS}
    seen: dict = {name: [] for name in FLAT_KERNELS}

    def recording(name):
        def call(*args):
            seen[name].append(args)
            return saved[name](*args)
        return call

    try:
        for name in FLAT_KERNELS:
            setattr(kernels, name, recording(name))
        run()
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)
    return seen


def flat_edge_args(dev, B: int, frames, Kc: int, L: int, e: int) -> dict:
    """Seeded arguments of the four flat-buffer kernels with their edge rows
    planted (flat_expand_inputs at every buffer size of flat_cap_cuts, with
    one start per read and with a start per frame; flat_sorted_keys and the
    scatter back of flat_scores on their dedup; select_grids), on `dev`,
    as phase_flat_kernels takes them: {label: {kernel: [args]}}."""
    import torch

    from bitmapperbs_tpu_torch.models import aligner
    from bitmapperbs_tpu_torch.ops import kernels

    blocks = tuple(b for _, b in frames)
    F = len(frames)
    S, occ_max, LB, CAP = E + 1, 128, 256, B * 42
    t = lambda a: torch.from_numpy(a).to(dev)        # noqa: E731
    out: dict = {}
    for shared in (True, False):
        x = {k: t(v) for k, v in flat_expand_inputs(
            40 + shared, B, F, S, occ_max, LB, shared).items()}
        args = (x["sp"], x["ep"], x["starts"], x["lengths"], blocks,
                occ_max, LB)
        occ = aligner.order_seeds(x["sp"], x["ep"], x["starts"],
                                  occ_max)[0].sum(-1).clamp(max=LB)
        occ = occ.reshape(-1).cpu().numpy()
        out[f"seeded intervals, {'a start per read' if shared else 'a start '
            'per frame'}, n_used {int(occ.sum())}, CAP at each cut"] = {
            "flat_expand": [args + (cap,) for cap in flat_cap_cuts(
                int(occ.sum()), occ, CAP)]}
    y = flat_sorted_keys(42, B, F, Kc, CAP, L)
    keyS, perm = torch.sort(t(y["key"]), stable=True)
    d_args = (keyS, perm, t(y["len_b"]), t(y["overflow"]), blocks, Kc)
    dd = kernels.flat_dedup_ref(*d_args)
    score = t(flat_scores(43, dd["keep"].cpu().numpy(), e))
    out["seeded keys with edge rows, and seeded scores on them"] = {
        "flat_dedup": [d_args],
        "scatter_back": [(keyS, dd["keep"], dd["rank"], score,
                          t(y["lengths"]), blocks, L, e, Kc)]}
    z = select_grids(44, B, frames, Kc, e, L)
    grids = {k: t(z[k]) for k in ("score", "fwd", "frame_a")}
    grids["bp"] = t(z["bp"])[None, :, None].expand(B, F, Kc)
    grids["overflow"] = torch.zeros(B, dtype=torch.bool, device=dev)
    grids["gdrop"] = torch.ones(B, dtype=torch.bool, device=dev)
    out["seeded grids with edge reads"] = {"select_se": [(grids, e)]}
    return out


def flat_bytes(name: str, args: tuple) -> int:
    """The bytes a flat-buffer kernel must move for these arguments: each
    input it needs read once (a broadcast start or bp code once), each
    output written once.  The scatter back needs the keep byte of the lanes
    of a row < R only, the score of the kept ones and the key and rank of
    those that land (score <= e); the selection needs every score, and the
    anchors and code of the cells with a finite score, or of every cell of
    a read that has none."""
    from bitmapperbs_tpu_torch import constants as K

    if name == "flat_expand":
        sp, _, starts, lengths, blocks, _, _, CAP = args
        B, F, S = sp.shape
        starts_n = B * S * (F if starts.stride(1) else 1)
        return (2 * sp.numel() + starts_n + B) * 8 \
            + CAP * (5 * 8 + 1) + 8 + B * F + B
    if name == "flat_dedup":
        keyS, _, _, overflow, _, _ = args
        CAP, R = keyS.numel(), overflow.numel()
        return CAP * 3 * 8 + R + CAP * (1 + 5 * 8) + R + 8
    if name == "scatter_back":
        keyS, keep, _, score, lengths, blocks, _, e, Kc = args
        B = lengths.numel()
        R = B * len(blocks)
        n_valid = int(((keyS >> 32) < R).sum())
        kept = int(keep.sum())
        land = int((keep & (score <= e)).sum())
        return n_valid + kept * 4 + land * (8 + 8) + B * 8 \
            + R * Kc * (4 + 8 + 8)
    grids, _ = args
    score, bp = grids["score"], grids["bp"]
    B, F, Kc = score.shape
    finite = score < K.INF_SCORE
    need = int((finite | ~finite.flatten(1).any(1)[:, None, None]).sum())
    bp_n = F if bp.stride(0) == 0 and bp.stride(2) == 0 else need
    return B * F * Kc * 4 + need * (8 + 8) + bp_n * 8 + B * (4 + 8 + 8 + 4)


def flat_equal(name: str, args: tuple, what: str) -> int:
    """A flat-buffer kernel against its plain version on the card, every
    output torch.equal (dtype and shape included); returns the largest
    absolute difference (0)."""
    import torch

    from bitmapperbs_tpu_torch.ops import kernels

    got = getattr(kernels, name)(*args)
    want = getattr(kernels, name + "_ref")(*args)
    torch.cuda.synchronize()
    assert got.keys() == want.keys(), (name, sorted(got), sorted(want))
    bad = [k for k, w in want.items() if got[k].dtype != w.dtype
           or got[k].shape != w.shape or not torch.equal(got[k], w)]
    assert not bad, f"{name} != plain on {what}: {bad}"
    return max(int((got[k].to(torch.int64) - w.to(torch.int64)).abs().max())
               if w.numel() else 0 for k, w in want.items())


def phase_flat_kernels(cases: dict, timed: dict, card: str) -> None:
    """The four flat-buffer kernels (csrc/flat.cu, no TPU kernel behind
    them) against their plain versions, every output torch.equal, on the
    arguments in `cases` ({label: {kernel: [args]}}, captured from real
    batches' device calls, and flat_edge_args' seeded edge rows); at the
    shapes in `timed` ({label: {kernel: args}}) each kernel's median call,
    inside (torch.profiler), CUDA-graph and plain times beside its bytes
    bound.  Adds to FLAT_RECORD; the first shape timed is a kernel's
    headline."""
    from bitmapperbs_tpu_torch.ops import kernels

    inside_names = {"flat_expand": "expand_", "flat_dedup": "dedup_kernel",
                    "scatter_back": "scatter_back_kernel",
                    "select_se": "select_se_kernel"}
    for name in FLAT_KERNELS:
        FLAT_RECORD.setdefault(name, {"max_abs_err": 0, "library_ms": None,
                                      "checked": [], "shapes": {}})
    rec = FLAT_RECORD
    for label, by_kernel in cases.items():
        for name, calls in by_kernel.items():
            for i, args in enumerate(calls):
                what = f"{label}, call {i + 1}"
                err = flat_equal(name, args, what)
                rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
                rec[name]["checked"].append(what)
            log(f"kernel {name}: all outputs equal to plain (torch.equal) "
                f"on {label}, {len(calls)} call(s)")
    for label, by_kernel in timed.items():
        for name, args in by_kernel.items():
            kern = getattr(kernels, name)
            plain = getattr(kernels, name + "_ref")
            ms = median_ms(lambda: kern(*args))
            inside = device_ms(lambda: kern(*args), inside_names[name])
            graph = graph_ms(lambda: kern(*args))
            plain_ms = median_ms(lambda: plain(*args))
            b = bound(flat_bytes(name, args), 0)
            shape = {"ms": ms, "device_ms": inside, "graph_ms": graph,
                     "plain_ms": plain_ms, **b}
            if not rec[name]["shapes"]:
                rec[name].update(shape)
            rec[name]["shapes"][label] = shape
            log(f"kernel {name}, {label}: median {ms:.4f} ms per call "
                f"({fmt_ms(inside)} inside, CUDA graph {graph:.4f}), plain "
                f"{plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms by bytes "
                f"({flat_bytes(name, args) / 1e6:.2f} MB); no single PyTorch "
                f"call computes it; {card}")


def gbp_index(device):
    """The planted-repeat genome's index, on the host and on the card, and
    the configuration the CLI tunes for a genome over 512 Mbp."""
    import argparse

    import numpy as np
    import torch

    from bitmapperbs_tpu_torch.cli import autotune_for_genome
    from bitmapperbs_tpu_torch.config import AlignerConfig
    from bitmapperbs_tpu_torch.index.build import build_index
    from bitmapperbs_tpu_torch.index.device import upload_index
    from bitmapperbs_tpu_torch.utils.simulate import repeat_genome_fasta

    t0 = time.perf_counter()
    fasta = repeat_genome_fasta(np.random.default_rng(1), contigs=GBP_CONTIGS)
    t1 = time.perf_counter()
    idx = build_index(fasta, jobs=2)
    del fasta
    t2 = time.perf_counter()
    dix = upload_index(idx, device)
    torch.cuda.synchronize()
    sizes = ", ".join(
        f"{name} {getattr(dix, name).numel() * 4 / 1e6:.1f} MB"
        for name in ("cp_rows", "sa_samples", "klt", "g_planes"))
    log(f"Gbp-config index: {sum(GBP_CONTIGS)} bp with planted repeats made "
        f"in {t1 - t0:.2f} s, built in {t2 - t1:.2f} s (2 block workers), "
        f"uploaded in {time.perf_counter() - t2:.2f} s: {sizes}, "
        f"{dix.nbytes / 1e6:.1f} MB in all; sa_rate {dix.sa_rate}, klt_k "
        f"{dix.klt_k}")
    assert dix.sa_rate == 4
    base = AlignerConfig(max_errors=E, indels=True, read_len_bucket=BUCKET,
                         batch_size=GBP_BATCH)
    cfg = autotune_for_genome(base, argparse.Namespace(), GBP_GENOME_BP)
    assert (cfg.seed_ext_max, cfg.seed_ext_occ, cfg.max_candidates) == \
        (20, 4, 128), cfg
    log(f"Gbp config: seed_ext {cfg.seed_ext_max} / occ {cfg.seed_ext_occ}, "
        f"max_candidates {cfg.max_candidates}, max_seed_occ "
        f"{cfg.max_seed_occ}, locate_budget {cfg.locate_budget}, batch "
        f"{cfg.batch_size}, flat cap "
        f"{cfg.resolve_flat_cap(dix.genome_len, 2)} slots per read")
    return idx, dix, cfg


def gbp_long_batch(idx, device):
    """Phase 12's reads of 280 bp: the simulated reads and their batch on
    the card."""
    import torch

    from bitmapperbs_tpu_torch.models.host import prepare_batch
    from bitmapperbs_tpu_torch.utils.simulate import simulate_reads

    sims = simulate_reads(idx.genome, N_LONG, read_len=LONG_READ_LEN,
                          seed=112, sub_rate=0.004, indel_rate=0.001)
    a, ln = prepare_batch([s.codes for s in sims], LONG_BUCKET, N_LONG)
    return sims, (torch.from_numpy(a).to(device),
                  torch.from_numpy(ln).to(device), int(ln.min()))


def gbp_pe_batches(idx, device):
    """Phase 13's pairs: the simulated pairs and their batches on the
    card."""
    import torch

    from bitmapperbs_tpu_torch.models.host import prepare_batch
    from bitmapperbs_tpu_torch.utils.simulate import simulate_pairs

    psims = simulate_pairs(idx.genome, N_GBP_PE_BATCHES * GBP_BATCH,
                           read_len=READ_LEN, seed=150, sub_rate=0.01,
                           indel_rate=0.005, min_insert=150, max_insert=480)
    batches = []
    for lo in range(0, len(psims), GBP_BATCH):
        mates = []
        for k in (0, 1):
            a, ln = prepare_batch([p[k].codes for p in psims[lo:lo
                                                             + GBP_BATCH]],
                                  BUCKET, GBP_BATCH)
            mates.append((torch.from_numpy(a).to(device),
                          torch.from_numpy(ln).to(device), int(ln.min())))
        (a1, l1, m1), (a2, l2, m2) = mates
        batches.append(((a1, l1, a2, l2), m1, m2))
    return psims, batches


def gbp_stage_tables(dix, cfg, long_batch, pe_batches) -> None:
    """Synced stage tables of the 280 bp batch and of the PE batches in the
    Gbp-scale configuration, and the PE path's device kernels, idle share
    and peak memory."""
    import torch

    from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device
    from bitmapperbs_tpu_torch.ops import kernels

    long_cfg = cfg.replace(read_len_bucket=LONG_BUCKET, batch_size=N_LONG)
    table, total = stage_table(dix, long_cfg, [long_batch] * 8)
    for name, ms in table.items():
        log(f"Gbp SE {LONG_READ_LEN} bp stage, synced, ms per {N_LONG}-read "
            f"batch: {name}: {ms:.3f}")
    log(f"Gbp SE {LONG_READ_LEN} bp stage total, synced per stage: "
        f"{total:.3f} ms per batch (medians over 8 runs of the batch)")

    pcfg = cfg.replace(paired=True, min_insert=MIN_INSERT,
                       max_insert=MAX_INSERT)
    table, total = pe_stage_table(dix, pcfg, pe_batches * 4)
    for name, ms in table.items():
        log(f"Gbp PE stage, synced, ms per {GBP_BATCH}-pair batch: {name}: "
            f"{ms:.3f}")
    log(f"Gbp PE stage total, synced per stage: {total:.3f} ms per batch "
        f"(medians over {4 * len(pe_batches)} runs of {len(pe_batches)} "
        f"batches)")
    saved = kernels.pair_join
    kernels.pair_join = kernels.pair_join_ref
    try:
        plain, plain_total = pe_stage_table(dix, pcfg, pe_batches * 4)
    finally:
        kernels.pair_join = saved
    log(f"Gbp PE stage with the plain pair join (the parent's), synced, ms "
        f"per {GBP_BATCH}-pair batch: pair join: {plain['pair join']:.3f}; "
        f"total {plain_total:.3f} (medians over {4 * len(pe_batches)} runs)")

    def all_batches():
        for args, m1, m2 in pe_batches:
            map_batch_pe_device(dix, pcfg, *args, min_read_len1=m1,
                                min_read_len2=m2)
        torch.cuda.synchronize()

    all_batches()
    torch.cuda.reset_peak_memory_stats(dix.device)
    all_batches()
    peak = torch.cuda.max_memory_allocated(dix.device) / 1e9
    idle = idle_share(all_batches)
    n = len(pe_batches)
    log(f"Gbp PE, {n} batches of {GBP_BATCH} pairs back to back: walls "
        f"{min(idle['walls_ms']):.2f}-{max(idle['walls_ms']):.2f} ms "
        f"unprofiled; under torch.profiler "
        f"{idle['device_kernels'] / n:.1f} device kernels and "
        f"{idle['busy_ms'] / n:.3f} ms of device time per batch; idle share "
        + ("{:.2f}-{:.2f}".format(*idle["idle"]) if "idle" in idle
           else "not measured (the profiler reported no device time)")
        + f"; peak device memory {peak:.2f} GB")


def gbp_variant(key: str, label: str, idx, dix, cfg, items: list,
                pe: bool, card: str) -> dict:
    """One more Gbp-scale configuration's main path on the planted-repeat
    index (phase 13c: the --pbat autotune, SE and PE; 13d: --sensitive):
    `items` (reads, or pairs of mates) through map_batch / map_batch_pe
    eager with its launches counted, SAM of a sample equal to the oracle's,
    the same items through the CUDA graphs (records equal, the replays
    under GRAPH_PATHS[key + "_graph"]), the batches against eager leaf by
    leaf with no host sync in the eager call, and the synced walls, idle
    share, kernels per batch, capture and pool (graph_walls).  Returns the
    eager run's launches."""
    import torch

    from bitmapperbs_tpu_torch import constants as K
    from bitmapperbs_tpu_torch.models import graphs as device_graphs
    from bitmapperbs_tpu_torch.models.host import map_batch, map_batch_pe
    from bitmapperbs_tpu_torch.ops import kernels
    from bitmapperbs_tpu_torch.oracle.paired import map_batch_pe as oracle_pe
    from bitmapperbs_tpu_torch.oracle.pipeline import map_batch_se

    mapper, oracle = (map_batch_pe, oracle_pe) if pe else (map_batch,
                                                           map_batch_se)
    names = [f"{key[:2]}{i}" for i in range(len(items))]
    quals = [(("I" * len(a)), ("I" * len(b))) for a, b in items] if pe \
        else ["I" * len(r) for r in items]
    reset_launches()
    t0 = time.perf_counter()
    recs = mapper(idx, dix, cfg, items, quals, names, graphs=False)
    launches = dict(kernels.LAUNCHES)
    wall = time.perf_counter() - t0
    for name in ("verify_fused_gather", "fm_locate", *FLAT_KERNELS,
                 *(("pair_join", "rescue_scan") if pe else ())):
        assert launches[name] > 0, f"{name} never ran on {label}"
    lines = [r.line() for r in recs]
    n = N_GBP_PE_ORACLE if pe else N_GBP_ORACLE
    want = [r.line() for r in oracle(idx, cfg, items[:n], quals[:n],
                                     names[:n])]
    bad = [i for i, (a, b) in enumerate(zip(want, lines)) if a != b]
    assert len(want) == (2 * n if pe else n) and not bad, \
        f"{label}: oracle mismatch at record {bad[0]}:\n{want[bad[0]]}\n" \
        f"{lines[bad[0]]}"
    grecs, replays, live = graph_path(
        key + "_graph", dix,
        lambda: mapper(idx, dix, cfg, items, quals, names))
    assert [r.line() for r in grecs] == lines, \
        f"{label}: records through CUDA graphs differ from the eager run's"
    mapped = sum(not r.flag & K.FLAG_UNMAPPED for r in recs) / len(recs)
    cap = cfg.resolve_flat_cap(dix.genome_len,
                               4 if cfg.non_directional else 2)
    log(f"{label}: {len(items)} {'pairs' if pe else 'reads'} mapped eager in "
        f"{wall:.2f} s (first call), launches {launches}; SAM of the first "
        f"{n} equals the oracle; mapped {mapped:.4f}; through CUDA graphs "
        f"{replays} replays of {len(live)} graph(s), records equal to the "
        f"eager run's; the replays launched {GRAPH_PATHS[key + '_graph']}; "
        f"flat cap {cap} slots per read, flat_chunks {cfg.flat_chunks}, Kc "
        f"{cfg.max_candidates}")
    host = host_batches(items, BUCKET, cfg.batch_size, pe)
    graphs_vs_eager(label, dix, cfg, host, pe)
    graph_walls(label, dix, cfg, host, pe, card)
    device_graphs.clear(dix)
    torch.cuda.synchronize()
    return launches


def run_gbp(card: str, span_args: tuple) -> tuple[dict, dict]:
    """Phases 12-14 on the planted-repeat genome; returns the records of
    the kernels checked on its index (gather_rows, the FM kernels,
    verify_fused_gather at the 288 bucket) and the launch counts of its
    main paths (phase 12's 96 bp batches, its 280 bp batch, phase 13, and
    phases 13c and 13d's PBAT and --sensitive paths)."""
    import argparse

    import torch

    from bitmapperbs_tpu_torch import constants as K
    from bitmapperbs_tpu_torch.cli import autotune_for_genome
    from bitmapperbs_tpu_torch.config import AlignerConfig
    from bitmapperbs_tpu_torch.index.build import save_index
    from bitmapperbs_tpu_torch.io.fastq import write_fastq
    from bitmapperbs_tpu_torch.io.stats import MapStats
    from bitmapperbs_tpu_torch.models import graphs as device_graphs
    from bitmapperbs_tpu_torch.models.aligner import map_batch_device
    from bitmapperbs_tpu_torch.models.host import (map_batch, map_batch_pe,
                                                   prepare_batch, to_host)
    from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device
    from bitmapperbs_tpu_torch.ops import kernels
    from bitmapperbs_tpu_torch.oracle.paired import map_batch_pe as oracle_pe
    from bitmapperbs_tpu_torch.oracle.pipeline import map_batch_se, se_frames
    from bitmapperbs_tpu_torch.utils.simulate import (simulate_pairs,
                                                      simulate_reads)

    device = torch.device("cuda", 0)
    idx, dix, cfg = gbp_index(device)
    cap = cfg.resolve_flat_cap(dix.genome_len, 2)

    # ---- phase 3 (gather_rows, the FM kernels, the gathering verify at
    # the 288 bucket: 9 read words) on this index's tables ------------------
    kstats = {"gather_rows": phase_gather_kernel(dix, GBP_BATCH * cap)}
    long_cfg = cfg.replace(read_len_bucket=LONG_BUCKET, batch_size=N_LONG)
    kstats["verify_fused_gather_long"] = phase_kernels(
        idx, dix, ("verify_fused_gather",),
        n_lanes=N_LONG * long_cfg.resolve_flat_cap(dix.genome_len, 2),
        m=LONG_BUCKET, read_len=LONG_READ_LEN,
        plain_reps=PLAIN_LONG_REPS)["verify_fused_gather"]
    # phase 3's span lanes on the 10 Mbp planes again, at this point of the
    # run: apart from the card's state, what the Gbp lanes cost more
    again = clocked_graph_ms(lambda: kernels.verify_fused_gather(*span_args))
    kstats["verify_fused_gather_long"]["ten_mbp_lanes_again"] = again
    log(f"kernel verify_fused_gather m {LONG_BUCKET}: phase 3's "
        f"{span_args[1].numel()} span lanes on the 10 Mbp planes again, "
        f"after the Gbp lanes: {again[0]:.4f} ms per launch at {again[1]} "
        f"MHz")

    t0 = time.perf_counter()
    n_sims = GBP_BIG_BATCH * N_GBP_BIG_BATCHES
    sims = simulate_reads(idx.genome, n_sims, read_len=READ_LEN, seed=110,
                          sub_rate=0.01, indel_rate=0.005)
    sat, n_arrays = satellite_reads(idx, N_GBP_SAT, seed=111)
    long_sims, long_batch = gbp_long_batch(idx, device)
    log(f"Gbp inputs: {n_sims} simulated reads, {N_GBP_SAT} reads from "
        f"{n_arrays} satellite arrays and {N_LONG} reads of {LONG_READ_LEN} "
        f"bp in {time.perf_counter() - t0:.2f} s")

    def to_dev(chunk, batch):
        a, ln = prepare_batch(chunk, BUCKET, batch)
        return (torch.from_numpy(a).to(device),
                torch.from_numpy(ln).to(device), int(ln.min()))

    small = [to_dev([s.codes for s in sims[lo:lo + GBP_BATCH]], GBP_BATCH)
             for lo in range(0, 8 * GBP_BATCH, GBP_BATCH)]
    big = [to_dev([s.codes for s in sims[lo:lo + GBP_BIG_BATCH]],
                  GBP_BIG_BATCH) for lo in range(0, n_sims, GBP_BIG_BATCH)]
    kstats.update(phase_fm_kernels(dix, cfg, small, big))

    # ---- phase 12: SE main path ---------------------------------------------
    n_main = N_GBP_MAIN_BATCHES * GBP_BATCH
    main_sims = sims[:n_main - N_GBP_SAT]
    reads = [s.codes for s in main_sims] + sat
    quals = [s.qual for s in main_sims] + ["I" * READ_LEN] * N_GBP_SAT
    qnames = [f"g{i}" for i in range(n_main)]

    reset_launches()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    stats = MapStats()
    recs = map_batch(idx, dix, cfg, reads, quals, qnames, stats=stats,
                     graphs=False)
    se_launches = dict(kernels.LAUNCHES)
    log(f"Gbp SE main path: {n_main} reads mapped in "
        f"{time.perf_counter() - t0:.2f} s (first call, eager), launches "
        f"{se_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    for name in ("gather_rows", "verify_fused_gather", "myers", *FM_KERNELS):
        assert se_launches[name] > 0, f"{name} never ran on the Gbp SE path"
    # a main path of its own: reads over 256 bp, whose 9 plane words take
    # the gathering verify's thread-group instance
    long_reads = [s.codes for s in long_sims]
    long_quals = [s.qual for s in long_sims]
    long_names = [f"l{i}" for i in range(N_LONG)]
    reset_launches()
    t0 = time.perf_counter()
    long_recs = map_batch(idx, dix, long_cfg, long_reads, long_quals,
                          long_names, graphs=False)
    long_launches = dict(kernels.LAUNCHES)
    log(f"Gbp SE main path, {LONG_READ_LEN} bp: {N_LONG} reads mapped in "
        f"{time.perf_counter() - t0:.2f} s (first call), launches "
        f"{long_launches}")
    for name in ("gather_rows", "verify_fused_gather", *FM_KERNELS):
        assert long_launches[name] > 0, \
            f"{name} never ran on the Gbp SE path at {LONG_READ_LEN} bp"
    assert long_launches["verify_fused_gather"] == 1, long_launches
    oracle = [r.line() for r in map_batch_se(
        idx, long_cfg, long_reads[:N_LONG_ORACLE], long_quals[:N_LONG_ORACLE],
        long_names[:N_LONG_ORACLE])]
    assert oracle == [r.line() for r in long_recs[:N_LONG_ORACLE]], \
        "Gbp oracle mismatch on the 280 bp reads"
    glong, _, _ = graph_path(
        "se_gbp_config_280bp_graph", dix,
        lambda: map_batch(idx, dix, long_cfg, long_reads, long_quals,
                          long_names))
    assert [r.line() for r in glong] == [r.line() for r in long_recs], \
        "280 bp records through a CUDA graph differ from the eager run's"
    log(f"Gbp SE main path: SAM of the first {N_LONG_ORACLE} reads of "
        f"{LONG_READ_LEN} bp equals the oracle; mapped "
        f"{sum(not r.flag & K.FLAG_UNMAPPED for r in long_recs) / N_LONG:.4f}"
        f", recall {recall(idx, long_sims, long_recs):.4f}")
    lines = [r.line() for r in recs]
    for lo, hi in ((0, N_GBP_ORACLE), (n_main - N_GBP_ORACLE_SAT, n_main)):
        oracle = [r.line() for r in map_batch_se(idx, cfg, reads[lo:hi],
                                                 quals[lo:hi], qnames[lo:hi])]
        bad = [i for i, (a, b) in enumerate(zip(oracle, lines[lo:hi]))
               if a != b]
        assert not bad, f"Gbp oracle mismatch at read {lo + bad[0]}:\n" \
                        f"{oracle[bad[0]]}\n{lines[lo + bad[0]]}"
    t0 = time.perf_counter()
    grecs, replays, live = graph_path(
        "se_gbp_config_graph", dix,
        lambda: map_batch(idx, dix, cfg, reads, quals, qnames))
    assert [r.line() for r in grecs] == lines, \
        "Gbp SE records through CUDA graphs differ from the eager run's"
    log(f"Gbp SE main path through CUDA graphs: {n_main} reads in "
        f"{time.perf_counter() - t0:.2f} s (captures included), {replays} "
        f"replays of {len(live)} graph(s), records equal to the eager run's "
        f"(and the 280 bp batch's through its graph); the replays launched "
        f"{GRAPH_PATHS['se_gbp_config_graph']}")

    main_dev = [to_dev(reads[lo:lo + GBP_BATCH], GBP_BATCH)
                for lo in range(0, n_main, GBP_BATCH)]
    outs = [to_host(map_batch_device(dix, cfg, a, ln, min_read_len=mn))
            for a, ln, mn in main_dev]
    gdrop = sum(int(o["gdrop"].sum()) for o in outs)
    assert gdrop > 0
    mapped = sum(not r.flag & K.FLAG_UNMAPPED for r in recs) / n_main
    sat_mapped = sum(not r.flag & K.FLAG_UNMAPPED
                     for r in recs[-N_GBP_SAT:]) / N_GBP_SAT
    log(f"Gbp SE main path: SAM of reads [0, {N_GBP_ORACLE}) and the last "
        f"{N_GBP_ORACLE_SAT} (satellite reads, gdrop re-run) equals the "
        f"oracle; mapped {mapped:.4f} (satellite reads {sat_mapped:.4f}), "
        f"recall of the simulated reads "
        f"{recall(idx, main_sims, recs):.4f}; capacity-overflow reads "
        f"{stats.overflow_reads}, gdrop reads {gdrop} (all in the last "
        f"batch: {int(outs[-1]['gdrop'].sum())})")

    # flat_chunks = 2 (what --sensitive sets at this scale): same tensors
    a, ln, mn = main_dev[0]
    chunked = to_host(map_batch_device(dix, cfg.replace(flat_chunks=2), a, ln,
                                       min_read_len=mn))
    for k, v in outs[0].items():
        assert (chunked[k] == v).all(), f"flat_chunks=2 differs in {k}"
    log("Gbp SE: flat_chunks=2 gives the first batch's tensors unchanged")

    # ---- throughput, stage table, idle share --------------------------------
    def device_rate(batches, c):
        def go():
            res = [map_batch_device(dix, c, a, ln, min_read_len=mn)
                   for a, ln, mn in batches]
            for o in res:
                o["best_score"].cpu()
        go()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        go()
        dt = time.perf_counter() - t0
        return (sum(b[0].shape[0] for b in batches) / dt,
                torch.cuda.max_memory_allocated(device) / 1e9)

    rps_small, peak_small = device_rate(small, cfg)
    rps_big, peak_big = device_rate(big, cfg.replace(batch_size=GBP_BIG_BATCH))
    e2e, e2e_lo, e2e_hi, again = host_rates(
        lambda: map_batch(idx, dix, cfg, reads, quals, qnames), n_main)
    assert [r.line() for r in again] == lines
    log(f"Gbp SE throughput: map_batch_device {rps_small:.1f} reads/s over "
        f"{len(small)} batches of {GBP_BATCH} (peak device memory "
        f"{peak_small:.2f} GB) and {rps_big:.1f} reads/s over {len(big)} "
        f"batches of {GBP_BIG_BATCH} (peak {peak_big:.2f} GB); end-to-end "
        f"map_batch {e2e:.1f} reads/s (median of {E2E_REPS} runs, "
        f"{e2e_lo:.1f}-{e2e_hi:.1f}) over phase 12's "
        f"{N_GBP_MAIN_BATCHES} batches (one gdrop re-run), on {card}")
    table, total = stage_table(dix, cfg, small)
    for name, ms in table.items():
        log(f"Gbp SE stage, synced, ms per {GBP_BATCH}-read batch: {name}: "
            f"{ms:.3f}")
    log(f"Gbp SE stage total, synced per stage: {total:.3f} ms per batch "
        f"(medians over {len(small)} batches)")

    def four_batches():
        for a, ln, mn in small[:4]:
            map_batch_device(dix, cfg, a, ln, min_read_len=mn)
        torch.cuda.synchronize()

    reset_launches()
    four_batches()
    per_batch = {k: v / 4 for k, v in kernels.LAUNCHES.items()}
    # once per candidate stage, the selection once per SE call
    assert all(per_batch[name] == 1 for name in FLAT_KERNELS), per_batch
    idle = idle_share(four_batches)
    log(f"Gbp SE, 4 batches of {GBP_BATCH} back to back: walls "
        f"{min(idle['walls_ms']):.2f}-{max(idle['walls_ms']):.2f} ms "
        f"unprofiled; under torch.profiler {idle['device_kernels']} device "
        f"kernels, {idle['busy_ms']:.3f} ms of device time; idle share "
        + ("{:.2f}-{:.2f}".format(*idle["idle"]) if "idle" in idle
           else "not measured (the profiler reported no device time)")
        + f"; launches per batch {per_batch}")

    # ---- phase 13: PE main path ------------------------------------------------
    pcfg = cfg.replace(paired=True, min_insert=MIN_INSERT,
                       max_insert=MAX_INSERT)
    t0 = time.perf_counter()
    psims, pe_batches = gbp_pe_batches(idx, device)
    pairs = [(a.codes, b.codes) for a, b in psims]
    pquals = [(a.qual, b.qual) for a, b in psims]
    pnames = [f"q{i}" for i in range(len(pairs))]
    log(f"Gbp PE inputs: {len(pairs)} simulated pairs in "
        f"{time.perf_counter() - t0:.2f} s")
    reset_launches()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    precs = map_batch_pe(idx, dix, pcfg, pairs, pquals, pnames, graphs=False)
    pe_launches = dict(kernels.LAUNCHES)
    log(f"Gbp PE main path: {len(pairs)} pairs mapped in "
        f"{time.perf_counter() - t0:.2f} s (first call, eager), launches "
        f"{pe_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    assert len(precs) == 2 * len(pairs)
    for name in ("gather_rows", "verify_fused_gather", "rescue_scan",
                 "pair_join", *FM_KERNELS):
        assert pe_launches[name] > 0, f"{name} never ran on the Gbp PE path"
    plines = [r.line() for r in precs]
    oracle = [r.line() for r in oracle_pe(idx, pcfg, pairs[:N_GBP_PE_ORACLE],
                                          pquals[:N_GBP_PE_ORACLE],
                                          pnames[:N_GBP_PE_ORACLE])]
    bad = [i for i, (a, b) in enumerate(zip(oracle, plines)) if a != b]
    assert len(oracle) == 2 * N_GBP_PE_ORACLE and not bad, \
        f"Gbp PE oracle mismatch at record {bad[0]}:\n{oracle[bad[0]]}\n" \
        f"{plines[bad[0]]}"
    proper = sum(bool(r.flag & K.FLAG_PROPER)
                 for r in precs[::2]) / len(pairs)

    def pe_run(batch):
        args, m1, m2 = batch
        return map_batch_pe_device(dix, pcfg, *args, min_read_len1=m1,
                                   min_read_len2=m2)

    reset_launches()
    hosts = [to_host(pe_run(b)) for b in pe_batches]
    per_batch = {k: v / len(pe_batches) for k, v in kernels.LAUNCHES.items()}
    assert per_batch["rescue_scan"] == 1, per_batch
    assert per_batch["pair_join"] == 1, per_batch
    # two candidate stages, a selection for each mate
    assert all(per_batch[name] == 2 for name in FLAT_KERNELS), per_batch
    log(f"Gbp PE: launches per map_batch_pe_device call {per_batch}")
    join = sum(int(h["pair_valid"].sum()) for h in hosts)
    resc = sum(int((h["resc_valid"] & ~h["pair_valid"]).sum()) for h in hosts)
    neither = len(pairs) - join - resc
    log(f"Gbp PE main path: SAM of pairs [0, {N_GBP_PE_ORACLE}) equals the "
        f"oracle; proper-pair rate {proper:.4f}, recall of the simulated "
        f"mates {recall(idx, [s for p in psims for s in p], precs):.4f}; "
        f"decided by pair join {join}, by rescue {resc}, by neither "
        f"{neither} of {len(pairs)} (compact pass; gdrop "
        f"{sum(int(h['gdrop'].sum()) for h in hosts)})")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = [pe_run(b) for b in pe_batches]
    for o in res:
        o["pair_sum"].cpu()
    pe_rps = 2 * len(pairs) / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    del res
    pe_e2e, pe_lo, pe_hi, again = host_rates(
        lambda: map_batch_pe(idx, dix, pcfg, pairs, pquals, pnames),
        2 * len(pairs))
    assert [r.line() for r in again] == plines
    log(f"Gbp PE throughput: map_batch_pe_device {pe_rps:.1f} reads/s over "
        f"{len(pe_batches)} batches of {GBP_BATCH} pairs (peak device memory "
        f"{peak:.2f} GB); end-to-end map_batch_pe {pe_e2e:.1f} reads/s "
        f"(median of {E2E_REPS} runs, {pe_lo:.1f}-{pe_hi:.1f}), on "
        f"{card}")
    t0 = time.perf_counter()
    gprecs, replays, live = graph_path(
        "pe_gbp_config_graph", dix,
        lambda: map_batch_pe(idx, dix, pcfg, pairs, pquals, pnames))
    assert [r.line() for r in gprecs] == plines, \
        "Gbp PE records through CUDA graphs differ from the eager run's"
    log(f"Gbp PE main path through CUDA graphs: {len(pairs)} pairs in "
        f"{time.perf_counter() - t0:.2f} s (captures included), {replays} "
        f"replays of {len(live)} graph(s), records equal to the eager run's; "
        f"the replays launched {GRAPH_PATHS['pe_gbp_config_graph']}")

    # ---- CUDA graphs against eager, the Gbp-config SE and PE batches --------
    se_host = [(a.cpu().numpy(), ln.cpu().numpy(), mn) for a, ln, mn in
               main_dev]
    graphs_vs_eager("Gbp config SE, phase 12's batches", dix, cfg, se_host,
                    False)
    graph_walls("Gbp config SE", dix, cfg,
                [(a.cpu().numpy(), ln.cpu().numpy(), mn)
                 for a, ln, mn in small[:4]], False, card)
    pe_host = [(*(x.cpu().numpy() for x in args), m1, m2)
               for args, m1, m2 in pe_batches]
    # a third batch in flight: the first with its mates swapped
    pe_host.append((*pe_host[0][2:4], *pe_host[0][:2], pe_host[0][5],
                    pe_host[0][4]))
    graphs_vs_eager("Gbp config PE, phase 13's batches and the first with "
                    "its mates swapped", dix, pcfg, pe_host, True)
    graph_walls("Gbp config PE", dix, pcfg, pe_host, True, card)
    device_graphs.clear(dix)

    # ---- phase 13c: the --pbat autotune (flat cap 192 in 3 chunks), SE and
    # PE; 13d: --sensitive (256 candidates in 2 chunks), SE -------------------
    base = AlignerConfig(max_errors=E, indels=True, read_len_bucket=BUCKET,
                         batch_size=GBP_BATCH)
    bcfg = autotune_for_genome(base.replace(non_directional=True),
                               argparse.Namespace(), GBP_GENOME_BP)
    scfg = autotune_for_genome(base, argparse.Namespace(sensitive=True),
                               GBP_GENOME_BP)
    assert (bcfg.locate_flat_cap, bcfg.flat_chunks) == (192, 3), bcfg
    assert (scfg.max_candidates, scfg.flat_chunks) == (256, 2), scfg
    bpcfg = bcfg.replace(paired=True, min_insert=MIN_INSERT,
                         max_insert=MAX_INSERT)
    n_var = N_GBP_VARIANT_BATCHES * GBP_BATCH
    pbat_reads = [x.codes for x in simulate_reads(
        idx.genome, n_var, read_len=READ_LEN, seed=130, sub_rate=0.01,
        indel_rate=0.005, protocols=("OT", "OB", "CTOT", "CTOB"))]
    # PBAT libraries read mate 1 off the complementary strands: every other
    # pair's mates swapped
    pbat_pairs = [(b.codes, a.codes) if i % 2 else (a.codes, b.codes)
                  for i, (a, b) in enumerate(simulate_pairs(
                      idx.genome, n_var, read_len=READ_LEN, seed=131,
                      sub_rate=0.01, indel_rate=0.005, min_insert=150,
                      max_insert=480))]
    variant_launches = {
        "se_gbp_pbat": gbp_variant(
            "se_gbp_pbat", "Gbp PBAT SE (--pbat autotune)", idx, dix, bcfg,
            pbat_reads, False, card),
        "pe_gbp_pbat": gbp_variant(
            "pe_gbp_pbat", "Gbp PBAT PE (--pbat autotune)", idx, dix, bpcfg,
            pbat_pairs, True, card),
        "se_gbp_sensitive": gbp_variant(
            "se_gbp_sensitive", "Gbp --sensitive SE", idx, dix, scfg,
            reads[:n_var], False, card)}

    # ---- phase 3 additions: the flat-buffer kernels on this index's batches
    one = {"Gbp SE batch (4,096 reads, Kc 128)": capture_flat_args(
        lambda: eager_call(dix, cfg, se_host[0], False)),
        "Gbp PBAT SE batch (flat cap 192)": capture_flat_args(
        lambda: eager_call(dix, bcfg, host_batches(
            pbat_reads[:GBP_BATCH], BUCKET, GBP_BATCH, False)[0], False)),
        "Gbp --sensitive SE batch (Kc 256)": capture_flat_args(
        lambda: eager_call(dix, scfg, se_host[-1], False)),
        "Gbp PE batch (both mates)": capture_flat_args(
        lambda: eager_call(dix, pcfg, pe_host[0], True))}
    edges = {f"{label}, {len(fr)} frames, Kc {kc}": calls
             for fr, kc in ((tuple(se_frames(cfg)), cfg.max_candidates),
                            (tuple(se_frames(bcfg)), WIDE_JOIN_KC))
             for label, calls in flat_edge_args(
                 device, GBP_BATCH, fr, kc, dix.genome_len, E).items()}
    phase_flat_kernels({**one, **edges}, {
        label: {name: calls[0] for name, calls in one[label].items()}
        for label in list(one)[:3]}, card)
    del one, edges                 # their tensors would count in later peaks

    # ---- phase 13b: trimmed reads -------------------------------------------
    phase_trimmed(idx, dix, cfg, pcfg, card)

    # ---- the pair join kernel on this index --------------------------------
    kstats["pair_join"] = phase_pair_join_kernel(dix, pcfg, pe_batches, card)

    gbp_stage_tables(dix, cfg, long_batch, pe_batches)

    # ---- phase 14: CLI with the Gbp flags on the saved artifact -----------------
    with tempfile.TemporaryDirectory(prefix="btbs_smoke_gbp_") as d:
        prefix = os.path.join(d, "ref")
        t0 = time.perf_counter()
        save_index(idx, prefix)
        t1 = time.perf_counter()
        fq = os.path.join(d, "reads.fq")
        write_fastq(fq, reads, qnames, quals)
        out = os.path.join(d, "out.sam")
        proc = subprocess.run(
            [sys.executable, "-m", "bitmapperbs_tpu_torch", "search", prefix,
             "--seq", fq, "-o", out, "--read-bucket", str(BUCKET),
             "--batch-size", str(GBP_BATCH), "--seed-ext",
             str(cfg.seed_ext_max), "--max-candidates",
             str(cfg.max_candidates), "--platform", "gpu"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"Gbp CLI failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        with open(out) as f:
            cli = [ln.rstrip("\n") for ln in f if not ln.startswith("@")]
        assert cli == lines, "Gbp CLI records differ from map_batch's"
        log(f"Gbp CLI (--seed-ext {cfg.seed_ext_max} --max-candidates "
            f"{cfg.max_candidates}): artifact saved in {t1 - t0:.2f} s, "
            f"{len(cli)} records equal to phase 12 "
            f"({time.perf_counter() - t1:.2f} s incl. start-up, index load "
            f"and upload)")
    return kstats, {"se_gbp_config": se_launches,
                    "se_gbp_config_280bp": long_launches,
                    "pe_gbp_config": pe_launches, **variant_launches}


def run(card: str) -> dict:
    """Phases 2-14 on cuda:0 (`card` labels the throughput lines); returns
    the kernels' JSON record."""
    import numpy as np
    import torch

    from bitmapperbs_tpu_torch.index.build import build_index, save_index
    from bitmapperbs_tpu_torch.utils.simulate import random_genome_fasta
    from bitmapperbs_tpu_torch.index.device import upload_index

    device = torch.device("cuda", 0)
    build_native()

    t0 = time.perf_counter()
    idx = build_index(random_genome_fasta(np.random.default_rng(0),
                                          contigs=GENOME_CONTIGS))
    t1 = time.perf_counter()
    dix = upload_index(idx, device)
    torch.cuda.synchronize()
    log(f"index: {sum(GENOME_CONTIGS)} bp, built in {t1 - t0:.2f} s, "
        f"uploaded in {time.perf_counter() - t1:.2f} s ({dix.nbytes / 1e6:.1f}"
        f" MB of tables; sa_rate {dix.sa_rate}, klt_k {dix.klt_k})")

    # ---- phase 3: kernels vs plain ------------------------------------------
    kstats = phase_kernels(idx, dix, ("myers", "verify_fused_gather"))
    gather_96 = kstats["verify_fused_gather"]
    gather_wide = {
        f"m {m} x {n} lanes": phase_kernels(
            idx, dix, ("verify_fused_gather",), n_lanes=n, m=m,
            read_len=read_len, plain_reps=1)["verify_fused_gather"]
        for m, read_len, n in WIDE_VERIFY_SHAPES}
    gather_wide[f"m {LONG_BUCKET} span"], span_args = phase_wide_span(
        idx, dix)
    kstats["rescue_scan"] = phase_rescue_kernel(idx, dix)

    with tempfile.TemporaryDirectory(prefix="btbs_smoke_idx_") as d:
        prefix = os.path.join(d, "ref")
        save_index(idx, prefix)            # for the CLI phases 6, 10, 11b
        se_launches, se_gdrop, se_cli = run_se(idx, dix, card, prefix, d)
        pe_launches, pe_gdrop, pe_cli = run_pe(idx, dix, card, prefix, d)
        wide_launches, kstats["rescue_scan"]["two_pass_pe_batch"], wide = \
            run_cli_extras(idx, dix, prefix, d, se_cli, pe_cli)
    kstats["gather_rows_shard"], mesh_paths, shard_stats = run_mesh(
        idx, dix, card, se_cli, pe_cli, wide)

    del idx, dix
    torch.cuda.empty_cache()
    gbp_kstats, gbp_paths = run_gbp(card, span_args)
    gather_long = gbp_kstats.pop("verify_fused_gather_long")
    kstats.update(gbp_kstats)
    kstats["verify_fused_gather"] = {
        **gather_96, "shapes": {f"m {BUCKET}": gather_96,
                                f"m {LONG_BUCKET}": gather_long,
                                **gather_wide}}

    # the slices' paths: the Gbp-config paths, the wide-insert PE batch and
    # the mesh paths of phase 11c
    slice_paths = {**gbp_paths, "pe_10mbp_insert_100k": wide_launches,
                   **mesh_paths}
    by_path = {"se_10mbp": se_launches, "pe_10mbp": pe_launches,
               **slice_paths}
    launches = {name: sum(p[name] for p in slice_paths.values())
                for name in KERNEL_SOURCES}
    tpu = {n for names in TPU_KERNEL_ENTRIES.values() for n in names}
    assert not tpu & set(NO_TPU_KERNEL_ENTRIES) and \
        tpu | set(NO_TPU_KERNEL_ENTRIES) == set(KERNEL_SOURCES)
    for tpu_kernel, names in TPU_KERNEL_ENTRIES.items():
        assert any(launches[name] > 0 for name in names), \
            f"no entry of {tpu_kernel} ({names}) launched on this slice's " \
            f"main paths"
    for name in NO_TPU_KERNEL_ENTRIES:
        assert launches[name] > 0, f"{name} launched on no main path"
    idle = sorted(name for name in KERNEL_SOURCES if launches[name] == 0)
    assert not idle, f"entries that no main path launched: {idle}"
    # the SHARD instances' records beside each kernel's own
    for name, rec in shard_stats.items():
        kstats[name]["shard"] = rec
    kstats.update(FLAT_RECORD)
    # what the graphed runs of the main paths launched: replays x captured
    assert set(GRAPH_PATHS) == {
        "se_10mbp_graph", "pe_10mbp_graph", "pe_10mbp_insert_100k_graph",
        "se_gbp_config_graph", "se_gbp_config_280bp_graph",
        "pe_gbp_config_graph", "se_gbp_pbat_graph", "pe_gbp_pbat_graph",
        "se_gbp_sensitive_graph"}, sorted(GRAPH_PATHS)
    return {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
         "replaces": KERNEL_SOURCES[name][1],
         "launches": launches[name], **kstats[name],
         "launches_by_path": {k: v[name] for k, v in by_path.items()},
         "replays_x_captured_launches_by_graph_path": {
             k: v[name] for k, v in GRAPH_PATHS.items()}}
        for name in KERNEL_SOURCES],
        "forced_gdrop_launches": {"se": se_gdrop, "pe": pe_gdrop}}


def main() -> int:
    import torch

    import bitmapperbs_tpu_torch  # noqa: F401  (fails outside the repo)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} device(s)")
    record = run(card)
    log(f"all phases passed on {card}")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
