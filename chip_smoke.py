#!/usr/bin/env python3
"""Smoke run of the PyTorch port's single-end search path on one CUDA card.

    python3 chip_smoke.py            (from the repository root)

Phases, each printing `[smoke] ...` lines; any failure raises (exit != 0):
  1. card: name and power limit (nvidia-smi), torch / CUDA versions
  2. build: the native finalize library (make) and the CUDA kernels (nvcc)
  3. each kernel vs its plain PyTorch version at the main path's shapes
     (163,840 lanes, m = 96, e = 4), torch.equal, median CUDA-event times
  4. main path: 10 Mbp two-contig genome, 4 x 16,384 reads through
     models.host.map_batch.  The last batch carries 1,024 low-complexity
     (pyrimidine-only, poly-T once converted) reads, as bisulfite libraries
     do; they overflow the flat buffer, so that batch takes the gdrop dense
     re-run.  SAM of the first 128 and the last 8 reads equals the numpy
     oracle's; mapped fraction and recall against the simulator.  The launch
     counts in the kernels' record are this phase's alone.
  5. forced gdrop: the first batch with locate_flat_cap=1 (dense fallback
     for every read) gives the same SAM as phase 4; its launches and peak
     device memory are reported apart from phase 4's
  6. CLI: `python -m bitmapperbs_tpu_torch search -t 4` (spawned finalize
     pool) in a subprocess gives the same records as phase 4
  7. throughput: map_batch_device reads/s over 8 distinct simulated batches
     (each synced by copying best_score to the host) and end-to-end
     map_batch reads/s over phase 4's 4 batches
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

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

KERNEL_SOURCES = {
    "verify_fused": "bitmapperbs_tpu/ops/pallas_kernels.py:212",
    "myers": "bitmapperbs_tpu/ops/pallas_kernels.py:29",
}


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


def build_native() -> None:
    from bitmapperbs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    native = os.path.join(ROOT, "bitmapperbs_tpu", "index", "sais_native")
    if not os.path.exists(os.path.join(native, "libsais.so")):
        subprocess.run(["make", "-C", native, "libsais.so"], check=True,
                       capture_output=True, timeout=600)
    t1 = time.perf_counter()
    so = kernels.build()
    t2 = time.perf_counter()
    log(f"build: libsais.so {t1 - t0:.2f} s, CUDA kernels {t2 - t1:.2f} s "
        f"({os.path.basename(so)})")
    # ptxas -v: one "Compiling entry function '<name>'" per kernel, then its
    # spill line and its register line
    name = spill = None
    with open(so + ".log") as f:
        for ln in f:
            if "Compiling entry function" in ln:
                name = ln.split("'")[1]
            elif "spill stores" in ln:
                spill = ln.split(",")[1].strip()
            elif "Used" in ln and "registers" in ln and name:
                regs = ln.split("Used")[1].split(",")[0].strip()
                log(f"ptxas: {name}: {regs}, {spill}")
                name = None


def kernel_inputs(idx, dix, n: int, seed: int):
    """Candidate lanes at the main path's widths: reads cut from either
    genome orientation with bisulfite conversion, per-lane substitution
    rates and indel-like offsets (ham <= e and ham > e both occur), N codes,
    reads shorter than the bucket, window starts that wrap below 0 and
    windows that run past the genome end."""
    import numpy as np
    import torch

    from bitmapperbs_tpu import constants as K
    from bitmapperbs_tpu_torch.ops import verify
    from bitmapperbs_tpu_torch.ops.u32 import bnot, wrap

    rng = np.random.default_rng(seed)
    m = BUCKET
    L = idx.genome.length
    ref = np.stack([idx.genome.codes, idx.genome.rc_codes()])
    orient = rng.integers(0, 2, n)
    anchor = rng.integers(0, L - m, n)
    k = n // 50
    anchor[:k] = rng.integers(0, E, k)                     # anchor - e < 0
    anchor[k:2 * k] = L - rng.integers(1, m, k)            # past the end
    lens = np.where(rng.random(n) < 0.2, rng.integers(m // 2, m + 1, n),
                    READ_LEN)
    shift = np.where(rng.random(n) < 0.3, rng.integers(-2, 3, n), 0)
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
    ncols = m + 2 * E
    wide = verify.window_planes(dix.g_planes, t(orient),
                                wrap(t(anchor) - E), -(-ncols // 32), L,
                                dix.g_words)
    peq, pad = verify.peq_from_planes(*rp, bnot(lm))
    return wide, rp, lm, peq, pad


def phase_kernels(idx, dix) -> dict:
    import torch

    from bitmapperbs_tpu_torch.ops import kernels

    m, ncols = BUCKET, BUCKET + 2 * E
    wide, rp, lm, peq, pad = kernel_inputs(idx, dix, KERNEL_LANES, seed=7)
    cases = {
        "verify_fused": (lambda: kernels.verify_fused(wide, rp, lm, m, ncols,
                                                      E),
                         lambda: kernels.verify_fused_ref(wide, rp, lm, m,
                                                          ncols, E)),
        "myers": (lambda: kernels.myers(wide, peq, pad, m, ncols),
                  lambda: kernels.myers_ref(wide, peq, pad, m, ncols)),
    }
    out = {}
    for name, (kern, plain) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape == (KERNEL_LANES,), (got.shape,
                                                            want.shape)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain on "
                                 f"{int((got != want).sum())} lanes")
        ms, plain_ms = median_ms(kern), median_ms(plain)
        if name == "verify_fused":
            frac = float((want <= E).float().mean())
            extra = f", result <= e on {frac:.3f} of lanes"
        else:
            extra = ""
        log(f"kernel {name}: {KERNEL_LANES} lanes equal to plain (max_abs_err"
            f" {err}{extra}); median {ms:.3f} ms vs plain {plain_ms:.3f} ms")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return out


def low_complexity_reads(n: int, seed: int):
    """Pyrimidine-only reads: C->T conversion turns them into poly-T, whose
    seeds hit tens of loci each on the converted genome."""
    import numpy as np

    from bitmapperbs_tpu import constants as K

    rng = np.random.default_rng(seed)
    return list(np.where(rng.random((n, READ_LEN)) < 0.5, K.C,
                         K.T).astype(np.uint8))


def recall(idx, sims, recs) -> float:
    """Share of the simulated reads placed on the true contig and strand
    within e of the true leftmost coordinate."""
    from bitmapperbs_tpu import constants as K

    ok = 0
    for s, r in zip(sims, recs):
        if r.flag & K.FLAG_UNMAPPED:
            continue
        ok += (r.rname == idx.genome.names[s.contig]
               and abs((r.pos - 1) - s.coord) <= E
               and bool(r.flag & K.FLAG_REVERSE) == s.is_reverse)
    return ok / len(sims)


def reset_launches() -> None:
    from bitmapperbs_tpu_torch.ops import kernels

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0


def run(card: str) -> dict:
    """Phases 2-7 on cuda:0 (`card` labels the throughput line); returns
    the kernels' JSON record."""
    import numpy as np
    import torch

    from bitmapperbs_tpu.config import AlignerConfig
    from bitmapperbs_tpu.index.build import build_index, save_index
    from bitmapperbs_tpu.io.fastq import write_fastq
    from bitmapperbs_tpu.oracle.pipeline import map_batch_se
    from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,
                                                simulate_reads)
    from bitmapperbs_tpu_torch.index.device import upload_index
    from bitmapperbs_tpu_torch.models.aligner import map_batch_device
    from bitmapperbs_tpu_torch.models.host import map_batch, prepare_batch
    from bitmapperbs_tpu_torch.ops import kernels

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
    kstats = phase_kernels(idx, dix)

    # ---- phase 4: main path -------------------------------------------------
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
    recs = map_batch(idx, dix, cfg, reads, quals, qnames)
    main_launches = dict(kernels.LAUNCHES)
    log(f"main path: {len(reads)} reads mapped in "
        f"{time.perf_counter() - t0:.2f} s (first call), launches "
        f"{main_launches}")
    assert len(recs) == len(reads)
    assert main_launches["verify_fused"] > 0, "fused kernel never ran"
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

    # ---- phase 5: gdrop dense fallback forced for a whole batch -------------
    cfg_g = cfg.replace(locate_flat_cap=1)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(device)
    recs_g = map_batch(idx, dix, cfg_g, reads[:BATCH], quals[:BATCH],
                       qnames[:BATCH])
    gdrop_launches = dict(kernels.LAUNCHES)
    assert gdrop_launches["myers"] > 0, "Myers kernel never ran (forced)"
    assert [r.line() for r in recs_g] == lines[:BATCH], "gdrop SAM differs"
    log(f"forced gdrop: {BATCH} reads re-run dense, SAM equal to phase 4; "
        f"launches {gdrop_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")

    # ---- phase 6: CLI, with the spawned finalize pool beside CUDA ------------
    with tempfile.TemporaryDirectory(prefix="btbs_smoke_") as d:
        prefix = os.path.join(d, "ref")
        save_index(idx, prefix)
        fq = os.path.join(d, "reads.fq")
        write_fastq(fq, reads, qnames, quals)
        out = os.path.join(d, "out.sam")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "bitmapperbs_tpu_torch", "search", prefix,
             "--seq", fq, "-o", out, "--read-bucket", str(BUCKET),
             "--batch-size", str(BATCH), "--platform", "gpu",
             "-t", str(CLI_THREADS)],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"CLI failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        with open(out) as f:
            cli = [ln.rstrip("\n") for ln in f if not ln.startswith("@")]
        assert cli == lines, "CLI records differ from map_batch's"
        log(f"CLI (-t {CLI_THREADS}): {len(cli)} records equal to phase 4 "
            f"({time.perf_counter() - t0:.2f} s incl. start-up)")

    # ---- phase 7: throughput ------------------------------------------------
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
    t0 = time.perf_counter()
    recs = map_batch(idx, dix, cfg, reads, quals, qnames)
    e2e_rps = len(reads) / (time.perf_counter() - t0)
    assert [r.line() for r in recs] == lines
    log(f"throughput: map_batch_device {dev_rps:.1f} reads/s over "
        f"{len(dev_batches)} simulated batches of {BATCH} (peak device "
        f"memory {peak:.2f} GB); end-to-end map_batch {e2e_rps:.1f} reads/s "
        f"over phase 4's {N_MAIN_BATCHES} batches (one gdrop re-run), on "
        f"{card}")

    return {"kernels": [
        {"name": name, "route": "cuda",
         "source": "bitmapperbs_tpu_torch/csrc/verify.cu",
         "replaces": KERNEL_SOURCES[name], "launches": main_launches[name],
         **kstats[name]} for name in ("verify_fused", "myers")],
        "forced_gdrop_launches": gdrop_launches}


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
