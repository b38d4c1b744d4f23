"""Stereo calibration geometry: the rational-quadratic dewarping.

Port of ``piv_liteflownet_tpu/stereo/dewarp.py``:

- ``nl_trans``: the 24-coefficient rational quadratic mapping, in float64 on
  the input's device (applied to flow values in ``stereo_run`` and to point
  coordinates in calibration);
- ``grid_regularize`` and ``map_coeff``: the grid snap and the two-stage
  Nelder-Mead fit, a few hundred points on the host in numpy/scipy, the JAX
  package's code copied;
- ``warp_image``: the nearest-neighbour remap of an image through the
  mapping, on the image's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _float64(a, device=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def nl_trans(x, y, A) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rational quadratic mapping with 24 coefficients, in float64 on ``x``'s device (the CPU for
    numpy input). The operations and their order are the JAX package's."""
    device = x.device if isinstance(x, torch.Tensor) else None
    x, y = _float64(x, device), _float64(y, device)
    A = [float(a) for a in np.asarray(A, np.float64)]
    x2, y2, xy = x * x, y * y, x * y
    new_x = (A[0] * x + A[1] * y + A[2] + A[3] * x2 + A[4] * y2 + A[5] * xy) / (
        A[6] * x + A[7] * y + A[8] + A[9] * x2 + A[10] * y2 + A[11] * xy
    )
    new_y = (A[12] * x + A[13] * y + A[14] + A[15] * x2 + A[16] * y2 + A[17] * xy) / (
        A[18] * x + A[19] * y + A[20] + A[21] * x2 + A[22] * y2 + A[23] * xy
    )
    return new_x, new_y


def grid_regularize(old_pts: np.ndarray, center_dist: Tuple[float, float], pt1: int,
                    n_iter: int = 3) -> np.ndarray:
    """Map detected cross centers to ideal grid nodes anchored at ``pt1``: each point gets
    ``old[pt1] + (col*dx, row*dy)`` of its node, the column and row assigned by rounding,
    the spacing re-estimated from the columns' and rows' centroids, ``n_iter`` times."""
    old = np.asarray(old_pts, np.float64)
    anchor = old[pt1]
    dx, dy = float(center_dist[0]), float(center_dist[1])

    col = np.round((old[:, 0] - anchor[0]) / dx)
    row = np.round((old[:, 1] - anchor[1]) / dy)
    for _ in range(n_iter):
        for vals, idx, d in ((old[:, 0], col, "dx"), (old[:, 1], row, "dy")):
            uniq = np.unique(idx)
            if len(uniq) > 1:
                cent = np.array([vals[idx == u].mean() for u in uniq])
                fit = np.polyfit(uniq, cent, 1)
                if d == "dx":
                    dx = float(fit[0])
                else:
                    dy = float(fit[0])
        col = np.round((old[:, 0] - anchor[0]) / dx)
        row = np.round((old[:, 1] - anchor[1]) / dy)

    return np.stack([anchor[0] + col * abs(dx) * np.sign(dx),
                     anchor[1] + row * abs(dy) * np.sign(dy)], axis=1)


def map_coeff(old_coord: np.ndarray, new_coord: np.ndarray, pt1: int) -> np.ndarray:
    """Fit the 24 mapping coefficients: a 12-coefficient rational-linear Nelder-Mead fit, then
    the 24-coefficient rational-quadratic one from it."""
    import scipy.optimize as so

    new_rel = np.asarray(new_coord, np.float64) - np.asarray(new_coord)[pt1]
    old_rel = np.asarray(old_coord, np.float64) - np.asarray(old_coord)[pt1]
    p, q = new_rel[:, 0], new_rel[:, 1]
    k1, k2 = old_rel[:, 0], old_rel[:, 1]

    def stage1(a):
        return np.sum(
            (k1 - (a[0] * p + a[1] * q + a[2]) / (a[3] * p + a[4] * q + a[5])) ** 2
            + (k2 - (a[6] * p + a[7] * q + a[8]) / (a[9] * p + a[10] * q + a[11])) ** 2
        )

    a = so.minimize(stage1, x0=np.array([1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 1], np.float64),
                    method="Nelder-Mead").x

    def stage2(A):
        x2, y2, xy = p * p, q * q, p * q
        num1 = A[0] * p + A[1] * q + A[2] + A[3] * x2 + A[4] * y2 + A[5] * xy
        den1 = A[6] * p + A[7] * q + A[8] + A[9] * x2 + A[10] * y2 + A[11] * xy
        num2 = A[12] * p + A[13] * q + A[14] + A[15] * x2 + A[16] * y2 + A[17] * xy
        den2 = A[18] * p + A[19] * q + A[20] + A[21] * x2 + A[22] * y2 + A[23] * xy
        return np.sum((k1 - num1 / den1) ** 2 + (k2 - num2 / den2) ** 2)

    x0 = np.array([a[0], a[1], a[2], 0, 0, 0, a[3], a[4], a[5], 0, 0, 0,
                   a[6], a[7], a[8], 0, 0, 0, a[9], a[10], a[11], 0, 0, 0], np.float64)
    return so.minimize(stage2, x0=x0, method="Nelder-Mead").x


def warp_image(gray_img, old_pts: np.ndarray, pt1: int, A) -> torch.Tensor:
    """Dewarp a grey image ``[H,W]`` (a tensor, or numpy for the CPU) through the mapping, by
    nearest-neighbour remap on its device: the source of each pixel is ``nl_trans`` of its
    position relative to the anchor point ``old_pts[pt1]``; a source outside the frame takes
    the far edge (the reference's fill). An image with no value above 1 is scaled by 255.
    Returns uint8."""
    img = torch.as_tensor(gray_img)
    if img.max() <= 1.0:
        img = img * 255
    img = img.to(torch.uint8)
    h, w = img.shape[:2]
    ax, ay = (float(c) for c in np.asarray(old_pts, np.float64)[pt1])
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=img.device),
                            torch.arange(w, dtype=torch.float64, device=img.device), indexing="ij")
    new_x, new_y = nl_trans(xs - ax, ys - ay, A)
    new_x = torch.round(new_x + ax)
    new_y = torch.round(new_y + ay)
    new_x = torch.where((new_x < 0) | (new_x > w - 1), w - 1, new_x).long()
    new_y = torch.where((new_y < 0) | (new_y > h - 1), h - 1, new_y).long()
    return img[new_y, new_x]
