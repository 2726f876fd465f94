"""Run one cell of the benchmark on this machine's cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout (BENCHMARK.json beside benchmark/).  It
prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), device, with ``--trace 1`` breakdown,
build_s (the seconds of the kernel library's build or load, a part of
setup_s), setup_parts (set-up's seconds by part), and last checks (each
number compared with its limit), which also end standard error.  It
exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and where the process has loaded JAX, its
libraries or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Build and kernel caches at fixed paths inside the checkout (the
    # port's own nvcc build already lives in urban_road_filter_torch/_build).
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    cell = harness.Cell(args.workload)
    # The scans are made on the host while torch loads and the card
    # starts: both are set-up.
    marks = [("start", T_START)]
    with ThreadPoolExecutor(max_workers=1) as ex:
        pool = ex.submit(harness.make_cell_pool, cell, args.seed)
        import torch

        marks.append(("imports", time.perf_counter()))
        if torch.cuda.is_available():
            from urban_road_filter_torch import _build

            torch.cuda.init()
            marks.append(("card", time.perf_counter()))
            # The nvcc build on a checkout's first run, a load after it.
            _build.library()
            marks.append(("kernel library", time.perf_counter()))
        pool = pool.result()
        marks.append(("scans", time.perf_counter()))
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    line, checks = harness.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), marks=marks,
                                    pool=pool)
    bad = harness.imported_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for text in checks:
        print(text, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
