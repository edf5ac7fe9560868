"""What the benchmark may import and read, and the shape of
``BENCHMARK.json``."""
import ast
import json
import re

import pytest

from bench.harness import ROOT

BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def top_level_imports(path):
    """Top-level names of every module a file imports (before the first
    dot, whole)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_system():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        mods = top_level_imports(path)
        assert "repro_torch" not in mods, path
        assert mods <= {"__future__", "dataclasses", "typing", "numpy",
                        "torch", "bench"}, (path, mods)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("bench."):
                assert node.module.startswith("bench.reference"), path


def test_top_level_names_are_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.engine".split(".")[0] in FORBIDDEN


def test_nothing_reads_the_jax_benchmarks():
    for path in BENCH.rglob("*"):
        if path.suffix not in (".py", ".json") or path.name == \
                "test_bench_isolation.py":
            continue
        text = path.read_text()
        assert "BENCH_" not in text.replace("BENCH_RUN", ""), path
        assert "benchmarks/" not in text and "benchmarks." not in text, path


def test_benchmark_json_follows_its_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"][1].startswith("bench/")
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert len(w["why"]) <= 200
    used = {w["config"] for w in b["workloads"]}
    assert used == configs
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= \
            set(moved.get("workloads", cells))
    for m in b["end_to_end"] + b["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").exists() or \
            (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").exists()
    for n in [*configs, *cells, *(m["name"] for m in b["end_to_end"]
                                  + b["per_layer"])]:
        assert NAME.match(n) and n not in names
        names.add(n)
