"""The benchmark's files: found by name, well formed, and free of JAX.

CPU only; run with `python -m pytest bench_cuda/tests -q`.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from bench_cuda import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_cuda"]
    assert BENCH["command"] == ["python3", "bench_cuda/run.py"]
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    find = harness.Finder()
    spec = find.json("cells", cell)
    assert spec["config"] == entry["config"]
    assert spec["chips"] == entry["chips"]
    assert find.path("drivers", spec["driver"], ".py").is_file()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for name in spec["end_to_end"]:
        assert cell in e2e[name].get("workloads", [cell])
    assert "setup_s" in spec["end_to_end"] and len(spec["end_to_end"]) >= 2
    assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_config_is_found_by_name(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    spec = json.loads((ROOT / entry["file"]).read_text())
    assert spec["name"] == config
    assert spec["reduced"] == entry["reduced"]
    assert spec["n_pad"] <= spec["gens_capacity"]
    assert any(w["config"] == config for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_is_found_and_reads_nothing_from_nothing(metric):
    reader = harness.Finder().module("metrics", metric)
    empty = {"proofs": 0, "host_span_s": 0.0, "device_events": 0, "kernel_calls": 0,
             "kernel_least_s": 0.0, "kernel_device_s": 0.0, "busy_s": 0.0, "window_s": 0.0}
    assert reader.read(empty) is None


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    # whole top-level names: the port's name begins with the JAX package's
    assert not _imports(path) & {"jax", "jaxlib", "flax", "dusk_blindbidproof_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "dusk_blindbidproof_tpu_torch" not in _imports(path)
    assert "torch" not in _imports(path)


def test_nothing_reads_the_jax_side_scripts():
    for path in SOURCES:
        if path.name == Path(__file__).name:
            continue
        text = path.read_text()
        for other in ("chip_smoke", "bench.py", "benchmarks/"):
            assert other not in text, (path, other)
        assert not re.search(r"(BENCH|MULTICHIP)_\w+\.json", text), path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "dusk_blindbidproof_tpu_torch_x", types.ModuleType("x"))
    assert "dusk_blindbidproof_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax.numpy" in harness.forbidden_modules()
