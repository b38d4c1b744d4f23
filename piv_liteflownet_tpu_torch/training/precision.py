"""How far a bf16 train step's gradients are from the float32 step's.

A bf16 step (``make_train_step(..., compute_dtype=torch.bfloat16)``) is held
to a float32 step on the same weights and batch, the truth, beside another
bf16 step of the same function, the reference (the JAX package's bf16 step,
or the plain ops' where the kernels are checked). Errors are relative L2
errors against the truth.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

GRAD_FLOOR = 0.02  # relative L2 error of one parameter's gradient that bf16 always allows


def rel_err(a: torch.Tensor, truth: torch.Tensor) -> float:
    """``|a - truth| / |truth|`` in float64 (L2 norms)."""
    a, truth = a.double(), truth.double()
    return float((a - truth).norm()) / max(float(truth.norm()), 1e-30)


def grad_relation(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  truth: Dict[str, torch.Tensor]) -> Dict[str, Tuple[float, float, float]]:
    """``got`` and ``ref`` held to ``truth``: part -> (got's error, ref's error, bound), ``got``
    passing where its error is at most the bound. The parts: the whole gradient as one vector
    and the median parameter, each bounded by twice ref's, and the worst parameter, bounded by
    twice ref's worst or ``GRAD_FLOOR``, whichever is larger."""
    names = list(truth)
    per_got = np.array([rel_err(got[n], truth[n]) for n in names])
    per_ref = np.array([rel_err(ref[n], truth[n]) for n in names])
    whole = [torch.cat([d[n].flatten() for n in names]) for d in (got, ref, truth)]
    r_whole = rel_err(whole[1], whole[2])
    r_median, r_worst = float(np.median(per_ref)), float(per_ref.max())
    return {"whole": (rel_err(whole[0], whole[2]), r_whole, 2 * r_whole),
            "median": (float(np.median(per_got)), r_median, 2 * r_median),
            "worst": (float(per_got.max()), r_worst, max(2 * r_worst, GRAD_FLOOR))}
