"""The least bytes each stage's kernels must move for one scan.

Each input byte read once and each output byte written once, evaluated from
the cell's shapes and from the reference's own counts of the scan (points
in the ROI, rings found, slots per ring), never from which kernels ran.
The per-kernel counts follow chip_smoke.py's phase-2 bounds, keyed here by
stage and lowered where a kernel need not touch every slot: a count that
is too low only lowers a roofline share, one that is too high would lift
it past 100 %.

A path is the list of kernel counts the entry runs per scan; a driver
names its path (``Driver.path``).
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12  # NVIDIA H100 SXM data sheet, at a 700 W limit
N_BINS = 361
MARKER_BINS = 362  # the flood's reach bits: one byte a degree and ring


def scan_counts(ref, dims: dict) -> dict:
    """The reference's counts of one scan: padded points n, ROI points
    roi, rings found, slots counted (points binned into a ring, up to the
    ring capacity), and the layout's rings and slots."""
    cap = int(dims["ring_capacity"])
    counted = sum(min(len(ids), cap) for ids in ref.ring_point_ids)
    return {"n": int(dims["max_points"]), "roi": int(ref.roi_mask.sum()),
            "rings_found": int(ref.num_rings), "counted": int(counted),
            "rings": int(dims["rings"])}


def _stage_bytes(c: dict, star: bool) -> dict:
    n, roi, found, slots, r = (c["n"], c["roi"], c["rings_found"],
                               c["counted"], c["rings"])
    reach = 2 * found * MARKER_BINS
    return {
        # K1: x, y, z read; valid (and the star keys) written.
        "ingest_prep": 12 * n + n + (8 * n if star else 0),
        # K2: valid and the ROI points' angles read, the ring table written.
        "discover": n + 4 * roi + 4 * r,
        # K3: valid, the ROI points' angles and the table read, ring ids
        # written.
        "assign": n + 4 * roi + 4 * r + 4 * n,
        # K4: the star keys read, the 360 beam hits written.
        "star_search": 8 * n + 4 * 360 if star else 0,
        # K5: ring ids read, positions and group totals written.
        "group_rank": 8 * n + 4 * (r + 1),
        # K6: ids, positions and x, y, z read; the counted slots' x, y, z
        # written.
        "place": 20 * n + 4 * (r + 1) + 12 * slots,
        # K7: x, y, z of the counted slots and the counts read, marks
        # written (none counted).
        "xz_zero": 12 * slots + 4 * r,
        # K8: azimuth and label of the counted slots read, reach written.
        "blocked": 8 * slots + 8 * r + reach,
        # K9: azimuth and label read and label written per counted slot,
        # reach read, the markers' first keys written.
        "labeled": 12 * slots + reach + 8 * r + 8 * N_BINS,
        # K12 (SP): azimuth read and the road mask written per slot.
        "flood_road": 5 * slots + reach + 8 * r,
        # K10: x, y, z of the counted slots and the counts read, the
        # marker table written.
        "marker_points": 12 * slots + 4 * r + 32 * N_BINS,
        # K14 (SP), a pass: azimuth and label of the counted slots read,
        # the state written.
        "marker_state": 8 * slots + 4 * r + 28 * N_BINS,
        # K11: ring ids, positions and valid read, three planes written,
        # and the table's word of each counted slot read.
        "gather_pack": 12 * n + 4 * slots,
    }


# Kernel counts per scan on each path: the single-scan and batch entries
# (K1-K11), and the SP run (K5 twice: the wedge rank and the tensorize;
# K14 twice; K12 in place of K9; the output scattered by glue).
PATHS = {
    "scan": {"ingest_prep": 1, "discover": 1, "assign": 1,
             "star_search": 1, "group_rank": 1, "place": 1, "xz_zero": 1,
             "blocked": 1, "labeled": 1, "marker_points": 1,
             "gather_pack": 1},
    "sp": {"ingest_prep": 1, "discover": 1, "assign": 1, "star_search": 1,
           "group_rank": 2, "place": 1, "xz_zero": 1, "blocked": 1,
           "flood_road": 1, "marker_state": 2},
}


def path_bytes(counts: dict, path: str, star: bool) -> float:
    """The least bytes one scan's kernels move on ``path``."""
    per = _stage_bytes(counts, star)
    return float(sum(per[k] * m for k, m in PATHS[path].items()))
