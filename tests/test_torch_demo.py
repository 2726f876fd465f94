"""The port's demo drive (examples/demo_torch.py) on the CPU: it replays a
scene through the port's harness, logs the beam_zone hot swap, and the
scans after the swap are labelled under the swapped configuration; with
matplotlib it renders a PNG; asked to render without matplotlib it fails
before the drive instead of pretending to render."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from urban_road_filter_torch import (
    FilterConfig, PipelineDims, pad_scan, process_scan)
from urban_road_filter_torch.constants import LABEL_ROAD
from urban_road_filter_torch.io.replay import scene_source

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "examples", "demo_torch.py")
DIMS = PipelineDims(max_points=32768, ring_capacity=2048, beam_capacity=512)


def _run(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, DEMO, "--device", "cpu", *args],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_demo_hot_swaps_beam_zone():
    out = _run("--render-every", "0", "--swap-at", "1", "--scans", "3")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "# hot-swapped beam_zone -> 50.0 at scan 1" in lines
    assert lines.index("# hot-swapped beam_zone -> 50.0 at scan 1") == 2
    stats = [json.loads(s) for s in lines if s.startswith('{"seq"')]
    assert [s["seq"] for s in stats] == [0, 1, 2]
    summary = json.loads(lines[-1])
    assert summary["scans"] == 3 and summary["errors"] == 0
    assert not any("rendered" in s for s in lines)
    # Scans up to the swap ran the default configuration, the one after it
    # beam_zone 50.
    scans = list(scene_source("two_curbs", n_scans=3, n_rings=32,
                              n_azimuth=1024))
    for seq, cfg in ((1, FilterConfig()),
                     (2, FilterConfig(beam_zone=50.0))):
        res = process_scan(torch.from_numpy(pad_scan(scans[seq],
                                                     DIMS.max_points)),
                           cfg, DIMS, device="cpu")
        road = int((res.labels.numpy() == LABEL_ROAD).sum())
        assert stats[seq]["road_points"] == road, (seq, road)
    res = process_scan(torch.from_numpy(pad_scan(scans[2], DIMS.max_points)),
                       FilterConfig(), DIMS, device="cpu")
    assert stats[2]["road_points"] != int(
        (res.labels.numpy() == LABEL_ROAD).sum())


def test_demo_renders_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    out = _run("--render-every", "5", "--scans", "1", "--out",
               str(tmp_path))
    assert out.returncode == 0, out.stderr
    png = tmp_path / "scan_0000.png"
    assert f"rendered {png}" in out.stdout.splitlines()
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_demo_refuses_to_render_without_matplotlib(monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location("demo_torch", DEMO)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    real = importlib.util.find_spec
    monkeypatch.setattr(demo.importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    with pytest.raises(SystemExit, match="needs matplotlib"):
        demo.main(["--device", "cpu", "--scans", "1", "--out",
                   str(tmp_path / "png")])
    assert not (tmp_path / "png").exists()
