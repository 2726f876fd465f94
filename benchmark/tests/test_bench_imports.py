"""What a run refuses: JAX or the JAX package loaded, no card, no program
beside the benchmark."""

from __future__ import annotations

import shutil
import subprocess
import sys
import types

import pytest

from benchmark import harness

ROOT = harness.ROOT


@pytest.mark.parametrize("planted", ["jax", "jax.numpy", "jaxlib", "flax",
                                     "urban_road_filter_tpu.ops"])
def test_import_check_catches_planted_module(planted, monkeypatch):
    monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
    assert planted.split(".")[0] in harness.imported_forbidden()


@pytest.mark.parametrize("name", ["urban_road_filter_torch",
                                  "urban_road_filter_torch.pipeline",
                                  "jaxtyping", "flax_like"])
def test_import_check_compares_whole_top_level_names(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert name.split(".")[0] not in harness.imported_forbidden()


def test_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from benchmark import harness, calibrate; "
            "import benchmark.drivers.closed_scan; "
            "import benchmark.drivers.closed_sp; "
            "import benchmark.drivers.closed_batch; "
            "import urban_road_filter_torch.pipeline; "
            "import urban_road_filter_torch.parallel.azimuth_parallel; "
            "print(harness.imported_forbidden())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "os1-64.scan",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_prints_no_result():
    """Here there is no CUDA card: the run fails and prints nothing on
    standard output (it never falls back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_run_with_only_the_benchmark_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and benchmark/: no program
    to run, no result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
