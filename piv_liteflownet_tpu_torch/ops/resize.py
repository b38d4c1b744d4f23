"""Bilinear resize with ``align_corners=False`` and no antialiasing, and the average pool.

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


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping ``k`` x ``k`` average pool (``nn.AvgPool2d(k, k)``) of ``[B,C,H,W]``.

    Port of ``piv_liteflownet_tpu/ops/resize.py:avg_pool`` (a VALID reduce
    window: a ragged edge is dropped); the identity for ``k == 1``.
    """
    if k == 1:
        return x
    return F.avg_pool2d(x, k, k)
