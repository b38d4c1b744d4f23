"""Bilinear resize with ``align_corners=False`` and no antialiasing.

Port of ``piv_liteflownet_tpu/ops/resize.py:resize_bilinear``, which builds
the same interpolation (half-pixel source coordinates clamped to the frame)
as explicit matrices. NCHW here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize ``[B,C,H,W]`` to ``(out_h, out_w)``; the identity when the size already matches."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)
