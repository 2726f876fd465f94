"""Demo drive of the PyTorch port: the launch/demo1.launch equivalent.

The port's form of examples/demo.py.  Where the reference launches the
node + rviz + rqt_reconfigure on the campus rosbag (launch/demo1.launch),
this script replays a synthetic drive through the port's ReplayHarness,
renders every Nth scan to PNG (the rviz displays) and hot-swaps beam_zone
to 50 mid-run through ``h.cfg``, which the harness reads on every scan
(the rqt_reconfigure interaction).

    python examples/demo_torch.py --out DIR --scans 20   # on the card
    python examples/demo_torch.py --device cpu --render-every 0 --swap-at 1

``--render-every 0`` renders nothing and needs no matplotlib; asking to
render without matplotlib fails before the drive starts.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from urban_road_filter_torch.config import FilterConfig, PipelineDims
from urban_road_filter_torch.io.replay import ReplayHarness, scene_source


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "urf_demo"))
    ap.add_argument("--scene", default="two_curbs")
    ap.add_argument("--scans", type=int, default=10)
    ap.add_argument("--render-every", type=int, default=5,
                    help="render every Nth scan to a PNG; 0 renders none")
    ap.add_argument("--swap-at", type=int, default=None,
                    help="scan index at which to hot-swap beam_zone to 50")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain "
                         "PyTorch twins)")
    args = ap.parse_args(argv)
    if args.render_every < 0:
        ap.error("--render-every must be >= 0")
    if args.render_every:
        if importlib.util.find_spec("matplotlib") is None:
            sys.exit("demo_torch: rendering needs matplotlib, which is not "
                     "installed; pass --render-every 0 to drive without it")
        from urban_road_filter_torch.viz import save_scan_png

        os.makedirs(args.out, exist_ok=True)

    dims = PipelineDims(max_points=32768, ring_capacity=2048,
                        beam_capacity=512)

    def on_scan(outputs):
        if args.render_every and outputs.seq % args.render_every == 0:
            path = os.path.join(args.out, f"scan_{outputs.seq:04d}.png")
            save_scan_png(outputs, path)
            print(f"rendered {path}")
        print(outputs.stats.to_json())
        # Live reconfiguration between scans (dynamic_reconfigure analogue).
        if args.swap_at is not None and outputs.seq == args.swap_at:
            h.cfg = h.cfg.replace(beam_zone=50.0)
            print(f"# hot-swapped beam_zone -> 50.0 at scan {outputs.seq}")

    h = ReplayHarness(cfg=FilterConfig(), dims=dims, on_scan=on_scan,
                      device=args.device)
    metrics = h.run(scene_source(args.scene, n_scans=args.scans,
                                 n_rings=32, n_azimuth=1024),
                    max_scans=args.scans)
    print(json.dumps(metrics.summary()))


if __name__ == "__main__":
    main()
