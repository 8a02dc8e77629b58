"""One run of one cell:

    python3 -m wgbs_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (`setup_s`, from the process's start to the first timed call): the
port's native library and CUDA kernels built into the checkout (first run
only), the configuration's genome and the port's index from the cache (made
there by the first run), the program's config from the configuration's CLI
flags (`cli.make_config`, then `cli.autotune_for_genome` on the genome size
the configuration states), the finalize pool, the index on the card, the
read pool drawn from `--seed` and written as FASTQ under TMPDIR, and
WARM_CALLS calls of the timed loop on the pool's first batches (the first
captures the cell's one graph; every other launch is a built kernel).

The window drives the port's host loop as `cli.cmd_search` does: batches
from `io.fastq.FastqReader` / `read_pairs` behind `io.fastq.Prefetcher`
(reopened at the end of the file), SE groups of `threads` reader batches
per `models.host.map_batch` call, PE one `map_batch_pe` call per batch,
graphs on, the pool and a MapStats; every record through
`io.sam.SamWriter` into a sink that counts its bytes.  It closes at the end
of the first call that completes `--seconds` after it opened.

After the window: the card's peak memory; in a traced run the rooflines;
then the program's state is freed and the plain reference maps a sample of
the pool drawn from the seed, whose records the window emitted, to decide
`correct`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from wgbs_bench import cache, cells, genome as genome_mod, traffic
from wgbs_bench.trace import Spans, read_profile

FORBIDDEN = ("jax", "jaxlib", "flax", "bitmapperbs_tpu")
PORT = "bitmapperbs_tpu_torch"
PROFILE_AT = 0.35           # the traced sub-window opens at this share
PROFILE_S = 4.0             # and lasts about this long (at most 30 %)
CHECK_LIMITS = {"mismatched_records": 0, "missing_records": 0}
WARM_CALLS = 2              # the first captures the cell's graph, the
                            # second replays it


def log(msg: str) -> None:
    """A progress line on standard error, with the process's age."""
    sys.stderr.write(f"[wgbs_bench {process_age_s():8.2f}s] {msg}\n")
    sys.stderr.flush()


def process_age_s() -> float:
    """Seconds since this process started (/proc: 10 ms steps)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def cpu_seconds(pids) -> float:
    """User + system seconds of the processes, from /proc/<pid>/stat."""
    tck = os.sysconf("SC_CLK_TCK")
    total = 0
    for pid in pids:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        total += int(fields[11]) + int(fields[12])
    return total / tck


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        return out[0] if out else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def build_native(port_dir: str) -> dict:
    """The port's native library (make) and CUDA kernels (nvcc), built
    into the checkout where missing; their seconds."""
    from bitmapperbs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    make = subprocess.run(
        ["make", "-C", os.path.join(port_dir, "index", "sais_native"),
         "libsais.so"], capture_output=True, text=True, timeout=900)
    if make.returncode != 0:
        raise RuntimeError(f"make libsais.so failed:\n{make.stdout}"
                           f"{make.stderr}")
    t1 = time.perf_counter()
    kernels.build()
    return {"make_s": t1 - t0, "nvcc_s": time.perf_counter() - t1}


def program_config(conf: dict):
    """The program's AlignerConfig from the configuration's CLI flags, as
    `search` builds it, tuned for the genome size the configuration states;
    and the parsed flags."""
    from bitmapperbs_tpu_torch import cli

    args = cli.build_parser().parse_args(["search", "ref", *conf["flags"]])
    cfg = cli.make_config(args)
    return cli.autotune_for_genome(cfg, args, int(conf["autotune_bp"])), args


def port_index(gen, conf: dict):
    """The port's index of the genome: loaded from the cache, or built by
    `index.build.build_index` from the genome's FASTA text and saved there
    first.  Returns (index, build seconds or 0)."""
    from bitmapperbs_tpu_torch.index.build import (build_index, load_index,
                                                   save_index)

    port_dir = os.path.dirname(sys.modules[PORT].__file__)
    d = cache.entry("index", conf["genome"], conf.get("index", {}),
                    cache.sources_hash(os.path.join(port_dir, "index")))
    secs = 0.0
    if not os.path.exists(os.path.join(d, "index.json")):
        t0 = time.perf_counter()
        opts = conf.get("index", {})
        idx = build_index(gen.fasta(), sa_rate=opts.get("sa_rate"),
                          klt_k=opts.get("klt_k"), jobs=2)
        tmp = cache.staging(d)
        save_index(idx, os.path.join(tmp, "index"))
        del idx
        cache.commit(tmp, d)
        secs = time.perf_counter() - t0
    return load_index(os.path.join(d, "index")), secs


def reference_index(gen):
    """The reference's view of the genome: its own padded codes and
    converted strands, made from the contigs (nothing cached, nothing of
    the program)."""
    from wgbs_bench.reference import index as ref_index

    return ref_index.Index(ref_index.Genome(gen.names, gen.contigs))


class Sink:
    """Where SamWriter writes: counts the bytes, keeps the last line."""

    def __init__(self):
        self.bytes = 0
        self.last = ""

    def write(self, s: str) -> int:
        self.bytes += len(s)
        self.last = s
        return len(s)

    def flush(self) -> None:
        pass


@dataclasses.dataclass
class Counts:
    reads: int = 0
    failed: int = 0
    calls: int = 0


class Loop:
    """The timed loop: the port's host path from FASTQ to SamWriter, as
    cmd_search runs it, cycling through the pool's file(s)."""

    def __init__(self, idx, dix, cfg, pool, paths, pe: bool, threads: int,
                 sampled, spans: Spans):
        from bitmapperbs_tpu_torch import cli
        from bitmapperbs_tpu_torch.io.fastq import (FastqReader, Prefetcher,
                                                    read_pairs)
        from bitmapperbs_tpu_torch.io.sam import SamWriter
        from bitmapperbs_tpu_torch.io.stats import MapStats
        from bitmapperbs_tpu_torch.models import host

        self.pe, self.spans = pe, spans
        self.stats = MapStats()
        self.sink = Sink()
        self.writer = SamWriter(self.sink, idx.genome.names,
                                idx.genome.lengths, cl=f"{PORT} search")
        self.sampled = sampled          # bool per pool read (pair)
        self.due: set = set()           # sampled reads sent in the window
        self.seen: dict = {}            # pool index -> record texts
        self.counts = Counts()
        self.cycles = 0
        group = 1 if pe else max(1, threads)
        n = len(self.sampled)

        def cycle():
            while True:
                self.cycles += 1
                if pe:
                    yield from read_pairs(paths[0], paths[1],
                                          cfg.batch_size)
                else:
                    yield from FastqReader(paths[0], cfg.batch_size)

        def run_se(c, codes, quals, qnames):
            return host.map_batch(idx, dix, c, codes, quals, qnames,
                                  stats=self.stats, pool=pool, graphs=True)

        def run_pairs(c, prs, quals, qnames):
            return host.map_batch_pe(idx, dix, c, prs, quals, qnames,
                                     stats=self.stats, pool=pool,
                                     graphs=True)

        def units():
            buf = []
            for item in self.prefetch:
                buf.append(item)
                if len(buf) == group:
                    yield buf
                    buf = []

        def call(unit):
            if pe:
                b1, b2 = unit[0]
                prs = list(zip(b1.codes, b2.codes))
                quals = list(zip(b1.quals, b2.quals))
                recs = cli._map_grouped_pe(run_pairs, cfg, None, prs, quals,
                                           b1.qnames)
                return b1.start_record, 2 * len(prs), recs
            codes = [c for b in unit for c in b.codes]
            qnames = [q for b in unit for q in b.qnames]
            quals = [q for b in unit for q in b.quals]
            recs = cli._map_grouped_se(run_se, cfg, None, codes, quals,
                                       qnames)
            return unit[0].start_record, len(codes), recs

        self.prefetch = Prefetcher(cycle())
        self.units = units()
        self.call = call
        self.units_per_cycle = n // (group * cfg.batch_size)

    def step(self) -> int:
        """One call: next unit, map, write; returns its reads."""
        with self.spans.span("input"):
            unit = next(self.units)
        with self.spans.span("map"):
            first, n_reads, recs = self.call(unit)
        per = 2 if self.pe else 1
        self.due.update(int(i) + first for i in np.flatnonzero(
            self.sampled[first:first + n_reads // per]))
        with self.spans.span("write"):
            for k, rec in enumerate(recs):
                self.writer.write(rec)
                self.stats.add_record(rec)
                i = first + k // per
                if self.sampled[i]:
                    self.seen.setdefault(i, [set(), set()])[k % per].add(
                        self.sink.last)
        self.counts.reads += n_reads
        self.counts.failed += max(0, n_reads - len(recs))
        self.counts.calls += 1
        return n_reads

    def close(self) -> None:
        self.prefetch.close()


def reference_lines(ref, spec, pool, names, idx, pe: bool) -> list:
    """The reference's SAM lines of the pool's reads (pairs) idx, one list
    (one line a mate) per read."""
    from wgbs_bench.reference import map_pairs, map_reads

    if pe:
        out = map_pairs(ref, spec, [pool[i] for i in idx],
                        [names[i] for i in idx])
        return [out[2 * j:2 * j + 2] for j in range(len(idx))]
    return [[w] for w in map_reads(ref, spec, [pool[i] for i in idx],
                                   [names[i] for i in idx])]


def check(seen: dict, idx, want, pe: bool) -> dict:
    """The sampled reads that the window emitted against the reference's
    lines: reads whose records differ (or that the window emitted in more
    than one way), and reads whose records never came."""
    per = 2 if pe else 1
    bad, missing, example = 0, 0, None
    for i, w in zip(idx, want):
        got = seen.get(i, [set(), set()])[:per]
        if any(len(g) == 0 for g in got):
            missing += 1
        elif any(g != {x + "\n"} for g, x in zip(got, w)):
            bad += 1
            if example is None:
                example = {"want": w, "got": [sorted(g) for g in got]}
    return {"mismatched_records": bad, "missing_records": missing,
            "compared": len(idx), "example": example}


def control_seen(ref, spec, pool, names, idx, pe: bool) -> dict:
    """What the window would have emitted for the sampled reads with the
    control in the program's place: the reference with indels off (the
    configurations state edit distance with indels)."""
    lines = reference_lines(ref, spec.replace(indels=False), pool, names,
                            idx, pe)
    return {i: [{x + "\n"} for x in w] for i, w in zip(idx, lines)}


def window(loop: Loop, seconds: float, spans: Spans, traced=None,
           cpu=lambda: 0.0):
    """Calls until one completes `seconds` after the window opened; with a
    `traced` card, a torch.profiler trace of a sub-window: the profiler
    starts at PROFILE_AT of the window, sees one call through its own
    start-up, then records PROFILE_S seconds (at most 30 % of the window) of
    whole calls inside a `wgbs.subwindow` range.  Returns (open, close,
    {"reads", "calls", "prof"} of the sub-window)."""
    import torch

    sub = {"reads": 0, "calls": 0, "prof": None, "paused_s": 0.0,
           "paused_cpu_s": 0.0, "paused_reads": 0}

    def resume():
        spans.paused = False
        sub["paused_s"] = time.perf_counter() - sub["p0"]
        sub["paused_cpu_s"] = cpu() - sub["cpu0"]
        sub["paused_reads"] = loop.counts.reads - sub["reads0"]
    prof = rf = None
    t_open = time.perf_counter()
    p_open = t_open + PROFILE_AT * seconds
    p_len = min(PROFILE_S, 0.3 * seconds)

    def stop():
        if traced.type == "cuda":
            torch.cuda.synchronize(traced)
        rf.__exit__(None, None, None)
        spans.profiling = False
        prof.__exit__(None, None, None)
        sub["prof"] = prof
        resume()

    while True:
        now = time.perf_counter()
        if traced is not None and prof is None and sub["prof"] is None \
                and now >= p_open:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            spans.paused, sub["p0"] = True, now
            sub["cpu0"], sub["reads0"] = cpu(), loop.counts.reads
            prof.__enter__()
        elif prof is not None and rf is None:
            rf = torch.profiler.record_function("wgbs.subwindow")
            rf.__enter__()
            spans.profiling = True
            sub["t0"] = now
        n = loop.step()
        now = time.perf_counter()
        if rf is not None:
            sub["reads"] += n
            sub["calls"] += 1
            if now - sub["t0"] >= p_len:
                stop()
                prof = rf = None
        if now >= t_open + seconds:
            break
    if rf is not None:              # the window closed first
        stop()
    elif prof is not None:          # before its sub-window began
        prof.__exit__(None, None, None)
        resume()
    return t_open, now, sub


def run(opts, device, faults=None, root: str = cells.ROOT
        ) -> tuple[dict, dict]:
    """One run of the cell on `device`; (result, info).  `faults` (tests)
    is a context manager entered around the warm-up and the window; `root`
    the checkout whose BENCHMARK.json and files name the cell."""
    import torch

    from bitmapperbs_tpu_torch.index.device import upload_index
    from bitmapperbs_tpu_torch.models import graphs as device_graphs
    from bitmapperbs_tpu_torch.models import host
    from bitmapperbs_tpu_torch.models.pool import make_finalize_pool
    from bitmapperbs_tpu_torch.ops import kernels

    c = cells.cell(opts.workload, root)
    conf, tr, work = c["config"], c["traffic"], c["workload"]
    pe = tr["mode"] == "pe"
    cuda = device.type == "cuda"
    info: dict = {"workload": work["name"], "seed": opts.seed,
                  "card": card_line() if cuda else "cpu",
                  "cpu_count": os.cpu_count()}
    port_dir = os.path.dirname(sys.modules[PORT].__file__)
    if cuda:
        info["first_run"] = build_native(port_dir)
        log(f"native build {info['first_run']}")
    gen, info["genome_s"] = genome_mod.load(conf["genome"])
    log(f"genome {gen.bp} bp ({info['genome_s']:.2f} s drawing)")
    idx, info["index_s"] = port_index(gen, conf)
    log(f"port index ({info['index_s']:.2f} s building)")
    cfg, args = program_config(conf)
    info["config"] = dataclasses.asdict(cfg)
    info["config_not_as_spec"] = {k: [getattr(cfg, k), v]
                                  for k, v in conf["spec"].items()
                                  if hasattr(cfg, k) and getattr(cfg, k) != v}
    n_pool = int(tr["pool"])
    unit = cfg.batch_size * (1 if pe else max(1, args.threads))
    if n_pool % unit:
        raise SystemExit(f"error: the pool ({n_pool}) is not a whole number "
                         f"of calls of {unit}")
    pool = make_finalize_pool(idx, cfg, args.threads)
    tmpdir = tempfile.mkdtemp(prefix="wgbs_bench_")
    spans = Spans(bool(opts.trace))
    loop = None
    try:
        dix = upload_index(idx, device)
        t0 = time.perf_counter()
        reads = traffic.make_pool(tr, gen, opts.seed)
        paths, names = traffic.write_pool(tr, reads, tmpdir)
        info["pool_s"] = time.perf_counter() - t0
        log(f"index on the card, read pool of {n_pool} drawn and written "
            f"({info['pool_s']:.2f} s)")
        sampled = np.zeros(n_pool, dtype=bool)
        sampled[traffic.check_sample(tr, opts.seed)] = True
        loop = Loop(idx, dix, cfg, pool, paths, pe, args.threads, sampled,
                    spans)
        pids = [os.getpid()] + ([p.pid for p in pool._pool] if pool else [])
        with (faults or contextlib.nullcontext)(), \
                spans.wrapped(host, "to_host", "to_host"):
            t0 = time.perf_counter()
            for _ in range(min(WARM_CALLS, loop.units_per_cycle)):
                loop.step()
            if cuda:
                torch.cuda.synchronize(device)
            info["warmup_s"] = time.perf_counter() - t0
            info["graphs"] = len(device_graphs.graphs(dix))
            log(f"warm-up pass {info['warmup_s']:.2f} s, "
                f"{info['graphs']} graphs; window opens")
            loop.seen.clear()
            loop.due.clear()
            loop.stats.__init__()
            loop.counts = Counts()
            spans.reset()
            setup_s = process_age_s()
            cpu0 = cpu_seconds(pids)
            t_open, t_close, sub = window(
                loop, opts.seconds, spans,
                device if opts.trace and cuda else None,
                lambda: cpu_seconds(pids))
            cpu1 = cpu_seconds(pids)
        window_s = t_close - t_open
        counts = loop.counts
        log(f"window closed: {counts.reads} reads in {window_s:.3f} s, "
            f"{counts.calls} calls")
        info.update(window_s=window_s, calls=counts.calls,
                    cycles=loop.cycles, sam_bytes=loop.sink.bytes,
                    stats=json.loads(loop.stats.to_json()), setup_s=setup_s)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "count": int(work["chips"]), "memory_peak_bytes": int(peak)}
        loop.close()
        if pool is not None:
            pool.terminate()
            pool.join()
            pool = None
        t = {"window_s": window_s, "spans_s": window_s - sub["paused_s"],
             "cpu_s": cpu1 - cpu0 - sub["paused_cpu_s"],
             "cpu_reads": counts.reads - sub["paused_reads"],
             "spans": dict(spans.totals),
             "call_walls": list(spans.call_walls), "profile": None,
             "roofline": None, "sub_reads": sub["reads"]}
        if opts.trace and cuda:
            if sub["prof"] is not None:
                t["profile"] = read_profile(sub.pop("prof"))
            t["roofline"] = rooflines(idx, dix, cfg, reads, pe, kernels,
                                      host)
        device_graphs.clear(dix)
        del dix
        if cuda:
            torch.cuda.empty_cache()
        bad = loaded_forbidden()
        if bad:
            raise SystemExit(f"error: loaded in the run's process: "
                             f"{', '.join(bad)}")
        log("program freed; reference")
        from wgbs_bench.reference.config import Spec

        t0 = time.perf_counter()
        ref = reference_index(gen)
        spec = Spec(**conf["spec"])
        due = sorted(loop.due)
        want = reference_lines(ref, spec, reads, names, due, pe)
        seen = loop.seen
        if getattr(opts, "control", None):
            info["program_check"] = check(seen, due, want, pe)
            seen = control_seen(ref, spec, reads, names, due, pe)
        chk = check(seen, due, want, pe)
        chk["reference_s"] = time.perf_counter() - t0
        log(f"reference compared {chk['compared']} in "
            f"{chk['reference_s']:.2f} s")
    finally:
        if loop is not None:
            loop.close()
        if pool is not None:
            pool.terminate()
            pool.join()
        shutil.rmtree(tmpdir, ignore_errors=True)
    info["check"] = chk
    reads_n = counts.reads
    correct = (chk["compared"] > 0 and counts.failed == 0
               and all(chk[k] <= v for k, v in CHECK_LIMITS.items()))
    if opts.trace:
        metrics = {}
        for m in c["per_layer"]:
            v = cells.reader(m["name"], root)(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {"reads_per_s": reads_n / window_s, "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in c["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in metrics.items() if k in units}
    result = {"correct": bool(correct), "attempted": reads_n,
              "failed": counts.failed, "metrics": metrics, "device": dev}
    if opts.trace and t["profile"]:
        p = t["profile"]
        dev["busy_s"], dev["window_s"] = p["busy_s"], p["window_s"]
        result["breakdown"] = {"device_ops": p["device_ops"],
                               "idle_gaps": p["idle_gaps"]}
        info["profile"] = {"device_events": p["device_events"],
                           "calls": sub["calls"], "reads": sub["reads"]}
    if t["roofline"]:
        info["roofline"] = t["roofline"]
    result["check"] = {k: {"value": chk[k], "limit": v}
                       for k, v in CHECK_LIMITS.items()}
    return result, info


def rooflines(idx, dix, cfg, reads, pe: bool, kernels, host) -> dict:
    """One batch of the pool mapped eagerly, each watched kernel's launches
    captured and timed alone against its bytes bound."""
    from wgbs_bench import roofline

    bs = cfg.batch_size
    if pe:
        def go():
            host.map_batch_pe(idx, dix, cfg, reads[:bs], graphs=False)
    else:
        def go():
            host.map_batch(idx, dix, cfg, reads[:bs], graphs=False)
    return roofline.measure(kernels, roofline.capture(kernels, go))


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m wgbs_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the control (the reference with indels off) "
                    "in the program's place for the check: the result must "
                    "come out not correct; the program's own check goes to "
                    "the INFO line")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    opts = parse(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("error: no CUDA device: the benchmark measures the "
                         "port on an NVIDIA card\n")
        return 2
    chips = int(cells.cell(opts.workload)["workload"]["chips"])
    if torch.cuda.device_count() < chips:
        sys.stderr.write(f"error: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} found\n")
        return 2
    result, info = run(opts, torch.device("cuda:0"))
    bad = loaded_forbidden()
    if bad:
        sys.stderr.write(f"error: loaded in the run's process: "
                         f"{', '.join(bad)}\n")
        return 3
    print("INFO " + json.dumps(info, default=str), flush=True)
    for k, v in result["check"].items():
        sys.stderr.write(f"check {k} {v['value']} limit {v['limit']}\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
