"""Helpers of the benchmark's CPU tests: a tiny checkout of two cells (a
350 kbp genome, batches of 64) whose runs drive the port's plain PyTorch
path on the CPU: tiny-se.bulk (the benchmark's directional SE cell) and
tiny-pe.wgbs (directional PE, whose records the port gets wrong in the ways
PERF.md's open questions name, so no test asks it to come out correct)."""
import json
import os
import shutil

from wgbs_bench import cells

TINY_GENOME = {"contigs": [200_000, 150_000], "gc": 0.42, "genome_seed": 5,
               "repeats": True}


def make_root(root, threads: int = 1) -> str:
    """A checkout under `root` with the real benchmark's files and two tiny
    cells, tiny-pe.wgbs and tiny-se.bulk."""
    pkg = os.path.join(root, "wgbs_bench")
    shutil.copytree(cells.PKG, pkg,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = cells.benchmark()
    bench["configs"] = [
        {"name": "tiny-pe", "source": "test", "reduced": [], "why": "test",
         "file": "wgbs_bench/configs/tiny-pe.json"},
        {"name": "tiny-se", "source": "test", "reduced": [], "why": "test",
         "file": "wgbs_bench/configs/tiny-se.json"}]
    bench["workloads"] = [
        {"name": "tiny-pe.wgbs", "config": "tiny-pe", "traffic": "tiny-pe",
         "chips": 1, "why": "test"},
        {"name": "tiny-se.bulk", "config": "tiny-se", "traffic": "tiny-se",
         "chips": 1, "why": "test"}]
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-se.bulk" if "flat" in m["name"]
                              else "tiny-pe.wgbs"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for name, src, traffic in (("tiny-pe", "hsim-dir-pe150", "wgbs"),
                               ("tiny-se", "hsim-dir-se150", "bulk-se")):
        with open(os.path.join(pkg, "configs", src + ".json")) as f:
            c = json.load(f)
        flags = c["flags"]
        flags[flags.index("-t") + 1] = str(threads)
        c.update(name=name, genome=TINY_GENOME,
                 flags=flags + ["--batch-size", "64"])
        with open(os.path.join(pkg, "configs", name + ".json"), "w") as f:
            json.dump(c, f)
        with open(os.path.join(pkg, "traffic", traffic + ".json")) as f:
            t = json.load(f)
        t.update(pool=256, check_sample=48)
        with open(os.path.join(pkg, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    return root


def tiny_run(root, workload: str, seed: int = 2**31 + 7, trace: int = 0,
             faults=None, seconds: float = 1.0, control: bool = False):
    import argparse

    import torch

    from wgbs_bench import run

    torch.set_num_threads(1)        # the tests run side by side
    opts = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace, control=control)
    return run.run(opts, torch.device("cpu"), faults=faults, root=root)
