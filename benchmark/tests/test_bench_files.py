"""BENCHMARK.json and the files it names: found by name, named and shaped
as the benchmark's contract asks, and a new cell, traffic, configuration
or metric added as new files only."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key]), e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key)
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.Cell(cell)
    assert c.chips == 1
    assert c.config["name"] == c.entry["config"]
    assert set(c.workload["limits"]) == set(harness.check.NUMBERS)
    cls = harness.driver_class(c.traffic["driver"])
    assert cls.path in harness.bounds.PATHS
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_found_by_name(metric):
    assert callable(harness.metric_reader(metric))


def test_metric_suffixes_share_a_reader():
    """copy_ms.batch and copy_ms.scan read through metrics/copy_ms.py."""
    for m in BENCH["per_layer"]:
        stem = m["name"].split(".")[0]
        assert (ROOT / "benchmark" / "metrics" / f"{stem}.py").is_file()
        assert (harness.metric_reader(m["name"]).__code__.co_filename
                == str(ROOT / "benchmark" / "metrics" / f"{stem}.py"))


def test_config_files():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/configs/")
        data = json.loads(path.read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] == []
        assert data["source"] == c["source"]


SNIPPET = """
import sys
sys.path.insert(0, sys.argv[1])
from benchmark import harness
cell = harness.Cell("extra.cell")
assert cell.config["name"] == "extra-config", cell.config
assert cell.traffic["pool"] == 3
assert harness.metric_reader("extra_ms.scan")(None) == 1.5
assert harness.metric_reader("extra_ms.batch")(None) == 2.5
print("found")
"""


def test_new_cell_needs_only_new_files(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix,
    cell and per-layer metric, each a new file and an entry in
    BENCHMARK.json: the harness finds every one by its name."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "os1-64-2048x10.json").read_text())
    cfg["name"] = "extra-config"
    (b / "configs" / "extra-config.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "scan.p16.json").read_text())
    traffic["pool"] = 3
    (b / "traffic" / "extra-mix.json").write_text(json.dumps(traffic))
    (b / "workloads" / "extra.cell.json").write_text(
        (b / "workloads" / "os1-64.scan.json").read_text())
    (b / "metrics" / "extra_ms.scan.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    (b / "metrics" / "extra_ms.py").write_text(
        "def read(ctx):\n    return 2.5\n")
    bench["configs"].append(dict(bench["configs"][0], name="extra-config",
                                 file="benchmark/configs/extra-config.json"))
    bench["workloads"].append({"name": "extra.cell", "config": "extra-config",
                               "traffic": "extra-mix", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", SNIPPET, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "found"
