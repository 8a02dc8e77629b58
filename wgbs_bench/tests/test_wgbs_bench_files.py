"""What the harness finds by name, and what it imports."""
import ast
import json
import os

from wgbs_bench import cells, run
from wgbs_bench.tests.helpers import make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "bitmapperbs_tpu"}


def imports(path):
    """Top-level names of every module a file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(sub=""):
    base = os.path.join(cells.PKG, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    """Compared by whole top-level names: bitmapperbs_tpu_torch (the port)
    is not bitmapperbs_tpu."""
    for path in sources():
        assert not imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert imports(path) <= {"__future__", "concurrent", "dataclasses",
                                 "numpy", "wgbs_bench"}, path


def test_loaded_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "bitmapperbs_tpu_torchx",
                        types.ModuleType("x"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.loaded_forbidden() == ["jax"]


def test_a_traffic_file_added_in_a_copy_is_found(tmp_path):
    root = make_root(str(tmp_path))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny-se.new", "config": "tiny-se",
                               "traffic": "newmix", "chips": 1,
                               "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(root, "wgbs_bench", "traffic",
                           "newmix.json"), "w") as f:
        json.dump({"mode": "se", "pool": 64, "foreign_share": 0.5}, f)
    c = cells.cell("tiny-se.new", root)
    assert c["traffic"]["foreign_share"] == 0.5
    assert c["config"]["name"] == "tiny-se"
    assert [m["name"] for m in c["per_layer"]] == [
        m["name"] for m in bench["per_layer"]
        if "tiny-se.new" in m.get("workloads", ["tiny-se.new"])]
    assert callable(cells.reader("io.wait_share", root))


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = cells.benchmark()
    for m in bench["per_layer"]:
        assert callable(cells.reader(m["name"]))
    for w in bench["workloads"]:
        c = cells.cell(w["name"])
        assert c["config"]["name"] == w["config"]
        assert c["traffic"]["pool"] % 4096 == 0
