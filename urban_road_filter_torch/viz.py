"""Lightweight scan visualizer — the rviz replacement (SURVEY.md section 5).

Renders one processed scan (road / curb / unlabeled points + marker strips)
as a top-down matplotlib figure, mirroring the demo rviz layout
(reference config/demo1.rviz shows the same five outputs).  Import is lazy
so headless/batch use never pays for matplotlib.

A copy of the JAX package's viz.py (matplotlib optional, as there), drawing
the port's io.replay.ScanOutputs.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

__all__ = ["plot_scan", "save_scan_png", "LiveViewer"]


def plot_scan(outputs, ax=None, max_points: int = 20000):
    """outputs: io.replay.ScanOutputs."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(9, 7))

    def sub(a):
        if len(a) > max_points:
            idx = np.random.default_rng(0).choice(len(a), max_points, replace=False)
            return a[idx]
        return a

    roi = sub(outputs.roi)
    ax.scatter(roi[:, 0], roi[:, 1], s=1.0, c="#c8c8c8", label="roi")
    road = sub(outputs.road)
    if len(road):
        ax.scatter(road[:, 0], road[:, 1], s=1.5, c="#2ca02c", label="road")
    curb = sub(outputs.curb)
    if len(curb):
        ax.scatter(curb[:, 0], curb[:, 1], s=4.0, c="#d62728", label="curb")
    if len(outputs.road_probably):
        pr = sub(outputs.road_probably)
        ax.scatter(pr[:, 0], pr[:, 1], s=2.0, c="#1f77b4", label="road_probably")

    for strip in outputs.marker_strips:
        if strip.action != "add" or len(strip.points) < 2:
            continue
        color = "#00a000" if strip.color == "green" else "#e00000"
        ax.plot(strip.points[:, 0], strip.points[:, 1], c=color, lw=1.8)

    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="upper right", markerscale=4, fontsize=8)
    ax.set_title(f"scan {outputs.seq}: {outputs.stats.road_points} road / "
                 f"{outputs.stats.curb_points} curb / rings {outputs.stats.num_rings}")
    return ax


def save_scan_png(outputs, path: str, **kw) -> None:
    import matplotlib.pyplot as plt

    ax = plot_scan(outputs, **kw)
    ax.figure.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(ax.figure)


class LiveViewer:
    """Follow-mode viewer — the interactive-rviz analogue (the reference
    demo watches config/demo1.rviz update at sensor rate; VERDICT r2
    missing-item 6).

    Usable directly as a `ReplayHarness(on_scan=...)` callback.  One
    persistent figure is redrawn in place, throttled to `rate_hz` so a
    600-scans/s replay doesn't drown the renderer:

      * interactive matplotlib backend (a desktop session): one window,
        updated via `plt.pause` — live follow like rviz;
      * headless/Agg: sequential `frame_NNNNN.png` files in `out_dir`
        (demo/CI artifact; `ffmpeg -i frame_%05d.png` makes the video).
    """

    def __init__(self, rate_hz: float = 10.0, out_dir: Optional[str] = None,
                 max_points: int = 20000):
        self.rate_hz = float(rate_hz)
        self.out_dir = out_dir
        self.max_points = max_points
        self.frames_drawn = 0
        self._ax = None
        self._last_draw = float("-inf")

    def _interactive(self) -> bool:
        import matplotlib

        return "agg" not in matplotlib.get_backend().lower()

    def __call__(self, outputs) -> None:
        now = time.monotonic()
        if self.rate_hz > 0 and now - self._last_draw < 1.0 / self.rate_hz:
            return  # throttle: skip frames arriving faster than the display
        self._last_draw = now

        import matplotlib

        if not self._interactive() and self.out_dir is None:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if self._ax is None:
            if self._interactive():
                plt.ion()
            _, self._ax = plt.subplots(figsize=(9, 7))
        else:
            self._ax.clear()
        plot_scan(outputs, ax=self._ax, max_points=self.max_points)

        if self._interactive():
            self._ax.figure.canvas.draw_idle()
            plt.pause(0.001)
        elif self.out_dir is not None:
            os.makedirs(self.out_dir, exist_ok=True)
            self._ax.figure.savefig(
                os.path.join(self.out_dir,
                             f"frame_{self.frames_drawn:05d}.png"), dpi=90)
        self.frames_drawn += 1

    def close(self) -> None:
        if self._ax is not None:
            import matplotlib.pyplot as plt

            plt.close(self._ax.figure)
            self._ax = None
