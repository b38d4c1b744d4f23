"""Dataset split tool (port of ``piv_liteflownet_tpu/data/split.py``).

Shuffle-splits the ``*_flow.flo`` files under a root (``np.random.default_rng(seed)``)
into train/val/test manifests, written as json, csv or txt.
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Optional, Sequence, Tuple

import numpy as np


def extract_dataset(
    root: str,
    outdir: Optional[str] = None,
    splits: Tuple[float, float, float] = (0.75, 0.15, 0.10),
    seed: int = 0,
    fmt: Sequence[str] = ("json",),
    relative: bool = True,
) -> dict:
    """Split the ``.flo`` population and write ``{train,val,test}.{json,csv,txt}``."""
    assert abs(sum(splits) - 1.0) < 1e-6, "splits must sum to 1"
    outdir = outdir or root
    flos = sorted(glob(os.path.join(root, "**", "*_flow.flo"), recursive=True))
    if not flos:
        flos = sorted(glob(os.path.join(root, "**", "*.flo"), recursive=True))
    assert flos, f"no .flo files under {root}"

    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(flos))
    n_train = int(splits[0] * len(flos))
    n_val = int(splits[1] * len(flos))
    parts = {
        "train": [flos[i] for i in idx[:n_train]],
        "val": [flos[i] for i in idx[n_train : n_train + n_val]],
        "test": [flos[i] for i in idx[n_train + n_val :]],
    }
    os.makedirs(outdir, exist_ok=True)
    for mode, files in parts.items():
        entries = [os.path.relpath(f, root) if relative else f for f in files]
        if "json" in fmt:
            with open(os.path.join(outdir, f"{mode}.json"), "w") as f:
                json.dump(entries, f, indent=1)
        if "txt" in fmt:
            with open(os.path.join(outdir, f"{mode}.txt"), "w") as f:
                f.write("\n".join(entries))
        if "csv" in fmt:
            with open(os.path.join(outdir, f"{mode}.csv"), "w") as f:
                f.write("filename\n" + "\n".join(entries))
    return {k: len(v) for k, v in parts.items()}
