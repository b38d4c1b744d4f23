"""The readings that a cell's limits are set from, on the card, in one process:

    python -m h100_bench.calibrate --workload <cell> --seeds 1 2 3 [--seconds 2] [--control]

For each seed: set-up, a short window at the cell's own load, and the check; with
``--control`` also the control (the reference a precision step below the configuration's,
put in the program's place) and what the driver's ``calibration`` adds (for the training
cell, the fault that leaves half of each batch out). Prints one JSON line a seed; ``--raw``
appends the raw readings behind them to a file.
"""

from __future__ import annotations

import argparse
import json
import time


def readings(workload: str, seed: int, seconds: float, control: bool) -> dict:
    import torch

    from h100_bench import harness

    _, _, cell = harness.load_cell(workload, seed, None)
    cell.device = harness.chip(cell.chips)
    driver = harness.load_driver(cell)
    t = time.perf_counter()
    driver.setup()
    driver.window(seconds)
    driver.release()
    out = {"seed": seed, "calls": driver.stats["calls"], **driver.calibration(control)}
    out["seconds"] = time.perf_counter() - t
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--raw", default=None, help="a file to append each seed's raw readings to")
    args = parser.parse_args(argv)
    for seed in args.seeds:
        out = readings(args.workload, seed, args.seconds, args.control)
        raw = out.pop("raw", None)
        if args.raw and raw is not None:
            with open(args.raw, "a") as f:
                f.write(json.dumps({"seed": seed, **raw}) + "\n")
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
