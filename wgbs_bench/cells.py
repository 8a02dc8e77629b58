"""Finds what BENCHMARK.json names, by name: a cell's configuration file,
its traffic file (`traffic/<name>.json`) and the readers of its per-layer
metrics (`metrics/<name>.py`).  A later cell or metric is new files and
entries, never an edit of a file that is there."""
from __future__ import annotations

import importlib.util
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, root: str = ROOT) -> dict:
    """{"workload", "config", "traffic", "end_to_end", "per_layer"} of the
    cell `name`: its entry, its configuration and traffic files' contents,
    and the metric entries it reports."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"error: no workload {name!r} in BENCHMARK.json "
                         f"(have: {', '.join(sorted(work))})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, os.path.basename(PKG), "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(m):
        return name in m.get("workloads", [name])

    return {"workload": w, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def reader(metric: str, root: str = ROOT):
    """The `read(trace) -> float | None` of metrics/<metric>.py."""
    path = os.path.join(root, os.path.basename(PKG), "metrics",
                        metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "wgbs_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
