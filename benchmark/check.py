"""How ``correct`` is decided: the program's outputs against the plain
reference, scan by scan.

Every number compared is a count over one scan (the worst scan of a run's
sample is reported), and each has a limit of its own in the cell's
workload file (``benchmark/workloads/<cell>.json``, "limits"):

  roi_diff            points whose ROI bit differs
  label_diff          ROI points whose label (none, road, curb) differs
  probably_road_diff  points whose probably_road bit differs
  marker_diff         1-degree bins whose marker row (present, x, y, z,
                      red) differs
  flag_diff           1 where ok differs, or num_rings differs on a scan
                      both sides evaluate

The reference sees the raw (M, 4) rows the benchmark made; the program's
outputs are per padded point (N >= M): its points past M are padding and
count against roi_diff if it marks them.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("roi_diff", "label_diff", "probably_road_diff", "marker_diff",
           "flag_diff")
N_BINS = 361


def unpack_planes(packed: np.ndarray):
    """The packed uint8 plane's (labels, roi, probably_road): labels in
    bits 0-1, roi in bit 2, probably_road in bit 3 (the program's wire
    format)."""
    return packed & 3, (packed & 4) != 0, (packed & 8) != 0


def reference_outputs(ref, n_points: int) -> dict:
    """The reference's result as the program publishes it: per padded
    point labels, roi and probably_road, the (361, 6) marker table
    (present, x, y, z, red, bin), ok and num_rings."""
    m = ref.roi_mask.shape[0]
    roi = np.zeros(n_points, bool)
    roi[:m] = ref.roi_mask
    ids = np.flatnonzero(ref.roi_mask)
    labels = np.zeros(n_points, np.uint8)
    labels[ids] = ref.labels
    probably = np.zeros(n_points, bool)
    probably[ids[ref.probably_road_ids]] = True
    table = np.zeros((N_BINS, 6), np.float32)
    for row, b in zip(ref.marker_points, ref.marker_bins):
        table[b] = (1.0, row[0], row[1], row[2], row[3], b)
    return {"labels": labels, "roi": roi, "probably_road": probably,
            "markers": table, "ok": bool(ref.ok),
            "num_rings": int(ref.num_rings)}


def compare(got: dict, want: dict) -> dict:
    """The numbers of one scan: ``got`` the program's outputs (host
    arrays: labels, roi, probably_road per padded point, markers (361,
    6), ok, num_rings), ``want`` reference_outputs of the same scan."""
    roi_g = np.asarray(got["roi"]).astype(bool)
    roi_w = want["roi"]
    lab_g = np.asarray(got["labels"]).astype(np.int64)
    lab_w = want["labels"].astype(np.int64)
    both = roi_g & roi_w
    mk_g = np.asarray(got["markers"], np.float32)
    mk_w = want["markers"]
    present_g, present_w = mk_g[:, 0] > 0, mk_w[:, 0] > 0
    rows_differ = np.any(mk_g[:, 1:5] != mk_w[:, 1:5], axis=1)
    marker = (present_g != present_w) | (present_g & present_w
                                         & rows_differ)
    ok_g = bool(got["ok"])
    flag = ok_g != want["ok"] or (
        want["ok"] and int(got["num_rings"]) != want["num_rings"])
    return {
        "roi_diff": int(np.count_nonzero(roi_g != roi_w)),
        "label_diff": int(np.count_nonzero(lab_g[both] != lab_w[both])),
        "probably_road_diff": int(np.count_nonzero(
            np.asarray(got["probably_road"]).astype(bool)
            != want["probably_road"])),
        "marker_diff": int(np.count_nonzero(marker)),
        "flag_diff": int(flag),
    }


def worst(per_scan: list) -> dict:
    """Each number's largest value over the compared scans."""
    return {k: max((d[k] for d in per_scan), default=0) for k in NUMBERS}


def verdict(per_scan: list, limits: dict) -> tuple:
    """(correct, failed scans, {number: {"value", "limit"}}): a scan
    fails where any of its numbers passes its limit; a run is correct
    where it compared at least one scan and none failed."""
    failed = sum(any(d[k] > limits[k] for k in NUMBERS) for d in per_scan)
    top = worst(per_scan)
    checks = {k: {"value": top[k], "limit": limits[k]} for k in NUMBERS}
    return bool(per_scan) and failed == 0, failed, checks


def bf16_rows(rows: np.ndarray) -> np.ndarray:
    """The control's input: the rows' x, y and z rounded to bfloat16 (the
    nearest precision below the configuration's float32; round to nearest
    even), kept in float32 storage."""
    out = np.array(rows, np.float32, copy=True)
    bits = out[:, :3].copy().view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    out[:, :3] = bits.view(np.float32)
    return out
