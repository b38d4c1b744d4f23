"""The trainer CLI's step with each loader, and with the model's small constants kept on the
card or built from host values every call, in turns on one card (a script, not collected by
pytest).

    python tests/loader_step_turns.py [--turns 2]

Renders 256 synthetic 384^2 pairs on the card (``make_dataset_dir``, 24 steps an epoch at
b8), then runs ``trainer.main`` (piv v1, crop 256^2 b8, 2 epochs, no validation) for every
combination of: the Python loader or ``--native_io``; the forward's rgb mean and
``estimate``'s scale kept on the card (``ops/nn.py:device_constant``, this tree) or built
from host values each call (a blocking copy, as before it); float32 or ``--bf16``. The
combinations run in turns, forwards then backwards, ``--turns`` times. Prints per run the
median ms/step (CUDA events around each step, without each epoch's first), the host's
median wait for a batch and the card's idle share between steps, as ``chip_smoke.py``'s
``cli_times`` reads them from the run's ``metrics.jsonl``; then the medians over the turns.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from piv_liteflownet_tpu_torch import inference  # noqa: E402
from piv_liteflownet_tpu_torch.data.piv_gen import make_dataset_dir  # noqa: E402
from piv_liteflownet_tpu_torch.models import liteflownet  # noqa: E402
from piv_liteflownet_tpu_torch.ops import conv_chain, correlation, rgb_warp, warp  # noqa: E402
from piv_liteflownet_tpu_torch.ops.nn import device_constant  # noqa: E402


def rebuilt(values, dtype, device):
    """A constant built from host values on every call: the blocking copy ``device_constant`` avoids."""
    return torch.tensor(values, dtype=dtype, device=device)


def step_stats(tr, steps: int) -> tuple:
    """(median ms/step, median host wait ms, idle share of the span) of a timed CLI run, without
    each epoch's first batch."""
    rows = [json.loads(line) for line in (Path(tr.experiment.dir) / "metrics.jsonl").read_text().splitlines()]

    def values(name):
        return [r["value"] for r in rows if r.get("metric") == "train_" + name and (r["step"] - 1) % steps]

    step, wait, idle = values("step_ms"), values("wait_ms"), values("idle_ms")
    return float(np.median(step)), float(np.median(wait)), sum(idle) / (sum(idle) + sum(step))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    ops = (correlation, warp, rgb_warp, conv_chain)
    combos = list(itertools.product(("python", "native"), ("kept", "rebuilt"), ("float32", "bf16")))
    results = {c: [] for c in combos}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "timed"
        make_dataset_dir(str(root), n=chip_smoke.TIME_N, size=chip_smoke.DATA_SIZE, seed=1)
        steps = int(0.75 * chip_smoke.TIME_N) // chip_smoke.TRAIN_B
        run = 0
        for turn in range(args.turns):
            for combo in (combos if turn % 2 == 0 else combos[::-1]):
                loader, constants, dtype = combo
                make = device_constant if constants == "kept" else rebuilt
                liteflownet.device_constant = inference.device_constant = make
                flags = (["--native_io"] if loader == "native" else []) + (["--bf16"] if dtype == "bf16" else [])
                try:
                    tr, _, _ = chip_smoke.run_cli(ops, root, Path(tmp) / f"run{run}", *flags, "--total_epochs", "2",
                                                  "--validation_dataset_mode", "none")
                finally:
                    liteflownet.device_constant = inference.device_constant = device_constant
                run += 1
                results[combo].append(step_stats(tr, steps))
                ms, wait, idle = results[combo][-1]
                print(f"turn {turn} {loader:6s} constants {constants:7s} {dtype:7s}: {ms:.3f} ms/step, host wait "
                      f"{wait:.3f} ms, idle {100 * idle:.2f} %", flush=True)
    print(f"medians over {args.turns} turns ({card}):", flush=True)
    for (loader, constants, dtype), rows in results.items():
        ms, wait, idle = (float(np.median([r[i] for r in rows])) for i in range(3))
        print(f"  {loader:6s} constants {constants:7s} {dtype:7s}: {ms:.3f} ms/step "
              f"{[round(r[0], 3) for r in rows]}, host wait {wait:.3f} ms, idle {100 * idle:.2f} %", flush=True)


if __name__ == "__main__":
    main()
