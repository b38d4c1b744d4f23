"""Flow colours and quiver plots (port of ``piv_liteflownet_tpu/utils/flow_viz.py``,
numpy only).

The Middlebury colour wheel, vectorized. Output channel order is BGR uint8
(``out[..., 2 - b]``), OpenCV's, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from piv_liteflownet_tpu_torch.utils.flow_io import unknown_flow


def make_colorwheel() -> np.ndarray:
    """55-color Middlebury wheel (RY=15, YG=6, GC=4, CB=11, BM=13, MR=6)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = 255 * np.arange(RY) / RY
    col += RY
    wheel[col : col + YG, 0] = 255 - 255 * np.arange(YG) / YG
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = 255 * np.arange(GC) / GC
    col += GC
    wheel[col : col + CB, 1] = 255 - 255 * np.arange(CB) / CB
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = 255 * np.arange(BM) / BM
    col += BM
    wheel[col : col + MR, 2] = 255 - 255 * np.arange(MR) / MR
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = make_colorwheel()


def compute_color(fx: np.ndarray, fy: np.ndarray, original_color: bool = False) -> np.ndarray:
    """Color one normalized flow field; returns uint8 [H, W, 3] in BGR order."""
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(fx * fx + fy * fy)
    a = np.arctan2(-fy, -fx) / np.pi
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = fk.astype(np.int64)
    k1 = (k0 + 1) % ncols
    f = 0.0 if original_color else (fk - k0)

    out = np.zeros(fx.shape + (3,), np.uint8)
    for b in range(3):
        col0 = _WHEEL[k0, b] / 255.0
        col1 = _WHEEL[k1, b] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        out[..., 2 - b] = (255.0 * col).astype(np.int64)
    return out


def motion_to_color(flow: np.ndarray, maxmotion: Optional[float] = None,
                    verbose: bool = False, original_color: bool = False) -> np.ndarray:
    """Color an [H,W,2] flow (or [L,H,W,2] sequence), normalizing by the max
    motion magnitude (or ``maxmotion``)."""
    single = flow.ndim == 3
    motim = flow[None] if single else flow
    fx, fy = motim[..., 0], motim[..., 1]
    maxrad = float(np.sqrt(fx ** 2 + fy ** 2).max())
    if maxmotion is not None:
        maxrad = maxmotion
    if maxrad == 0:
        maxrad = 1.0
    if verbose:
        print(f"normalizing by {maxrad}")
    colim = np.stack(
        [compute_color(fx[i] / maxrad, fy[i] / maxrad, original_color) for i in range(motim.shape[0])]
    )
    colim[unknown_flow(fx, fy)] = 0
    return colim[0] if single else colim


def quiver_plot(flow: np.ndarray, coord: Optional[np.ndarray] = None,
                filename: Optional[str] = None, norm: bool = False, show: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Quiver plot of a flow field (matplotlib, Agg); saved to ``filename`` (a ``.png``)
    when given. Returns (u, v)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    u = flow[:, :, 0]
    v = flow[:, :, 1]
    if norm:
        mag = np.sqrt(u ** 2 + v ** 2).max() or 1.0
        u, v = u / mag, v / mag
    if coord is None:
        h, w = u.shape
        x = np.arange(0, w) + 0.5
        y = np.arange(0, h)[::-1] + 0.5
        xp, yp = np.meshgrid(x, y)
    else:
        xp, yp = coord[:, :, 0], coord[:, :, 1]
    plt.quiver(xp, yp, u, v)
    plt.axis("equal")
    if show:  # pragma: no cover
        plt.show()
    if filename is not None:
        assert isinstance(filename, str)
        assert filename[-4:] == ".png", f"File extension is not an image format ({filename[-4:]!r})"
        plt.savefig(filename)
    plt.clf()
    return u, v
