"""Cells of BENCHMARK.json cut to a size a CPU test run can hold: the same
files, with fewer firings a scan (and the dims to match), a smaller pool
and batch, and a smaller sample."""

from __future__ import annotations

import copy

from benchmark import harness


def tiny_cell(name: str, firings: int = 128, pool: int = 2,
              batch: int = 4, sample: int = 2) -> harness.Cell:
    cell = harness.Cell(name)
    cell.config = copy.deepcopy(cell.config)
    rings = int(cell.config["dims"]["rings"])
    cell.config["firings"] = firings
    cell.config["dims"] = {"max_points": rings * firings, "rings": rings,
                           "ring_capacity": firings, "beam_capacity": 64}
    cell.traffic = dict(cell.traffic, pool=pool)
    if "batch" in cell.traffic:
        cell.traffic["batch"] = batch
    cell.workload = dict(cell.workload, sample=sample)
    return cell


CELLS = [w["name"] for w in harness.benchmark_file()["workloads"]]
