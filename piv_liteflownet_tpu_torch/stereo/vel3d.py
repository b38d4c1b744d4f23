"""Stereo 2D3C reconstruction (Willert 1997), on tensors.

Port of ``piv_liteflownet_tpu/stereo/vel3d.py``: from the two cameras'
planar flows and their off-axis half-angles theta (x-z plane) and beta (y-z
plane), the three-component velocity. Index 0 is the left camera, 1 the
right one.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def willert(flow: Sequence[torch.Tensor], theta: Tuple[float, float],
            beta: Tuple[float, float]) -> torch.Tensor:
    """``[H,W,3]`` float64 (U, V, W) from two ``[H,W,2]`` camera flows, on their device.

    The arithmetic is the JAX package's numpy arithmetic step for step: differences and sums
    of the flows in their own dtype, every product with an angle's tangent in float64.
    """
    u = [f[..., 0] for f in flow]
    v = [f[..., 1] for f in flow]
    t0, t1 = (float(np.tan(a)) for a in theta)
    b0, b1 = (float(np.tan(a)) for a in beta)
    du = (u[1] - u[0]).double()
    u_3c = (u[1].double() * t0 - u[0].double() * t1) / (t0 - t1)
    v_3c = ((v[0] + v[1]) / 2).double() + du * (b1 - b0) / (t0 - t1) / 2
    w_3c = du / (t0 - t1)
    return torch.stack([u_3c, v_3c, w_3c], dim=-1)
