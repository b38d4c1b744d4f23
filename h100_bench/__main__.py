"""``python -m h100_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``: one run of
one cell of ``BENCHMARK.json`` on this machine's CUDA card.

Prints the numbers the check compared, each beside its limit, as the last lines of standard
error, and the result as one JSON object on the last line of standard output. Exits with 2
and prints no result where the card is missing, and with 3 where JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (0 where that cannot be read)."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_S = process_age_s()


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    # the program's build and kernel caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))

    parser = argparse.ArgumentParser(prog="python -m h100_bench", description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from h100_bench import harness

    # one thread for the host's own tensor work (the loader's row gathers): the program's host
    # path runs as fast as the card in the training cell, and idle threads spinning beside it
    # make its rate swing
    torch.set_num_threads(1)
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               process_age_s=AGE_S, t_start=T_START)
    except harness.NoChip as e:
        print(f"h100_bench: {e}", file=sys.stderr, flush=True)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"h100_bench: the run loaded {found}; nothing of JAX or the JAX package may run here",
              file=sys.stderr, flush=True)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']} attempted {out['attempted']} failed {out['failed']}",
          file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
