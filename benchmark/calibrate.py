"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 2] [--out readings.json]

For each seed, one short run of the cell in this process (its own pool,
driver and capture, the cell's own load and sample) and the worst of each
compared number over its sample: the program's readings.  For each
control seed, the control in the program's place: the reference on the
pool's rows with x, y and z rounded to bfloat16 (check.bf16_rows),
compared with the reference on the rows themselves, scan by scan: the
control's readings.  The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(cell, seed: int) -> dict:
    """The worst of each number over the pool of ``seed`` with the
    bfloat16 control in the program's place."""
    from benchmark import check, reference, scans

    cfg = cell.config
    pool = scans.make_pool(cell.traffic, cfg["sensor"], int(cfg["firings"]),
                           seed)
    settings = reference.filter_settings(cfg["filter"])
    rings = int(cfg["dims"]["rings"])
    n = int(cfg["dims"]["max_points"])
    per_scan = []
    for rows in pool:
        want = check.reference_outputs(
            reference.run_oracle(rows, settings, channels=rings), n)
        got = check.reference_outputs(
            reference.run_oracle(check.bf16_rows(rows), settings,
                                 channels=rings), n)
        per_scan.append(check.compare(got, want))
    return check.worst(per_scan)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    cell = harness.Cell(args.workload)
    out = {"cell": cell.name, "program": {}, "control": {}}
    for s in [int(x) for x in args.seeds.split(",") if x]:
        t0 = time.perf_counter()
        line, _ = harness.run_cell(cell, s, args.seconds, False)
        out["program"][s] = {k: v["value"] for k, v in line["checks"].items()}
        print(f"program seed {s}: {out['program'][s]} correct "
              f"{line['correct']} attempted {line['attempted']} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t0 = time.perf_counter()
        out["control"][s] = control_readings(cell, s)
        print(f"control seed {s}: {out['control'][s]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for kind in ("program", "control"):
        if out[kind]:
            vals = list(out[kind].values())
            agg = max if kind == "program" else min
            out[f"{kind}_reading"] = {k: agg(v[k] for v in vals)
                                      for k in vals[0]}
            print(f"{kind} reading ({agg.__name__} over seeds): "
                  f"{out[f'{kind}_reading']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
