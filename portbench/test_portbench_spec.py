"""BENCHMARK.json against the contract's shape and the files it names:
every cell, configuration, traffic mix and metric found by its name, each
reader declaring what BENCHMARK.json says of it; and the whole-name import
check."""
import ast
import json
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from pbcore import harness  # noqa: E402
from pbcore.spec import HERE, ROOT, Bench  # noqa: E402

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_shape():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    names += [c["name"] for c in B["configs"] + B["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_cells_find_their_files():
    bench = Bench()
    e2e = {m["name"] for m in B["end_to_end"]}
    for w in B["workloads"]:
        cell = bench.cell(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and got <= e2e
        assert cell.per_layer, w["name"]
        assert all(m["moves"] in got for m in cell.per_layer)
        assert bench.generator(cell.traffic["kind"]).generate
        assert bench.reference(cell.config["reference"]).logits
    for c in B["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"


def test_readers_declare_what_the_benchmark_says():
    bench = Bench()
    for m in B["end_to_end"] + B["per_layer"]:
        r = bench.reader(m["name"])
        assert r.UNIT == m["unit"] and r.SOURCE == m["source"]
        assert r.BETTER == m["better"]
        if "layer" in m:
            assert r.LAYER == m["layer"] and r.MOVES == m["moves"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.serving", "jaxtyping", "numpy",
         "flaxen", "reprox"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.models", "jax", "jax.numpy", "jaxlib", "flax.nn",
         "repro_torch"]) == ["flax.nn", "jax", "jax.numpy", "jaxlib",
                             "repro", "repro.models"]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "repro", "benchmarks"), (path, m)
        if path.name != Path(__file__).name:
            text = path.read_text()
            assert "BENCH" + "_" not in text, path
            assert "benchmarks" + "/" not in text, path
