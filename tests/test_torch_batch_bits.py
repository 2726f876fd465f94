"""Every output field of the port's entry points held to pinned bits.

process_batch, process_scan and packed_scan on seven lanes that differ (three
scenes at 24 rings, a flat scene, a scan of 10 points under the 30-point
gate, an empty scan and a 12-ring scan of 512 azimuths), in four
configurations and both layouts: a digest of each field (its dtype, shape
and bytes, all lanes) must equal the one in tests/fixtures/
torch_batch_bits.json.  Those digests were written with

    python tests/test_torch_batch_bits.py --write

from the port as it was before its batch path took a lane axis (commit
fb15911, where process_batch ran the stages lane by lane), so the lane
axis is held to give the same bits as the loop it replaced.  Torch runs on
one thread here and when the digests are written.
"""

import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from urban_road_filter_torch import (  # noqa: E402
    FilterConfig, PipelineDims, pad_scan, packed_scan, planarize_batch,
    process_batch, process_scan)
from urban_road_filter_torch.convert import to_numpy  # noqa: E402
from urban_road_filter_torch.io.synthetic import SCENES, make_scan  # noqa: E402

torch.set_num_threads(1)  # tier-1 runs several pytest workers

PINNED = ROOT / "tests" / "fixtures" / "torch_batch_bits.json"
DIMS = PipelineDims(max_points=16384, rings=32, ring_capacity=512)
CONFIGS = {"star": FilterConfig(),
           "star_off": FilterConfig(star_shaped_method=False),
           "x1_starbeam": FilterConfig(x_direction=1, starbeam_filter=True),
           "no_blind_no_xzero": FilterConfig(blind_spots=False,
                                             x_zero_method=False)}
LAYOUTS = ("rows", "planar")
PACKED = ("packed", "markers", "ok", "num_rings", "overflow")


def _rows() -> np.ndarray:
    scans = [make_scan(SCENES[s](), n_rings=24, n_azimuth=384, seed=7 + i)
             for i, s in enumerate(("two_curbs", "blind_spot", "curb_gap",
                                    "flat"))]
    scans += [np.tile(np.float32([[1, 0, -2, 0]]), (10, 1)),
              np.zeros((0, 4), np.float32),
              make_scan(SCENES["two_curbs"](), n_rings=12, n_azimuth=512,
                        seed=3)]
    return np.stack([pad_scan(s, DIMS.max_points) for s in scans])


def _digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    h = hashlib.sha256(f"{a.dtype.str} {a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()[:20]


def digests(rows: np.ndarray, cname: str, layout: str) -> dict:
    """{entry point: {field: digest}} of the three entry points on rows
    (B, N, 4) in one configuration and layout; the single-scan entries'
    fields stacked over the lanes."""
    cfg = CONFIGS[cname]
    pts = torch.from_numpy(rows if layout == "rows"
                           else planarize_batch(rows))
    lanes = [pts[k] if layout == "rows" else pts[:, k]
             for k in range(rows.shape[0])]
    batch = to_numpy(process_batch(pts, cfg, DIMS, layout=layout,
                                   device="cpu"))
    scans = [to_numpy(process_scan(lane, cfg, DIMS, layout=layout,
                                   device="cpu")) for lane in lanes]
    packed = [[t.numpy() for t in packed_scan(lane, cfg, DIMS,
                                              layout=layout, device="cpu")]
              for lane in lanes]
    return {
        "process_batch": {f: _digest(getattr(batch, f))
                          for f in batch._fields},
        "process_scan": {f: _digest(np.stack([getattr(s, f)
                                              for s in scans]))
                         for f in batch._fields},
        "packed_scan": {f: _digest(np.stack([p[i] for p in packed]))
                        for i, f in enumerate(PACKED)}}


@pytest.fixture(scope="module")
def rows():
    return _rows()


@pytest.fixture(scope="module")
def pinned():
    return json.loads(PINNED.read_text())


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_fields_equal_pinned_bits(rows, pinned, cname, layout):
    """Every field of the three entry points equal to its pinned bits."""
    got = digests(rows, cname, layout)
    want = pinned[f"{cname}/{layout}"]
    assert {e: set(f) for e, f in got.items()} == {
        e: set(f) for e, f in want.items()}
    wrong = [f"{e}.{f}" for e in sorted(want) for f in sorted(want[e])
             if got[e][f] != want[e][f]]
    assert not wrong, f"{cname}/{layout}: fields that differ: {wrong}"


def main() -> int:
    if sys.argv[1:] != ["--write"]:
        print(__doc__)
        return 2
    rows = _rows()
    out = {f"{c}/{layout}": digests(rows, c, layout)
           for c in sorted(CONFIGS) for layout in LAYOUTS}
    PINNED.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    count = sum(len(f) for d in out.values() for f in d.values())
    print(f"wrote {PINNED}: {count} digests")
    return 0


if __name__ == "__main__":
    sys.exit(main())
