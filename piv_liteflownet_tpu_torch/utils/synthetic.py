"""Synthetic particle-image pairs for runs that must not read files (numpy only)."""

from __future__ import annotations

import numpy as np


def particle_pair(b: int, h: int, w: int, seed: int, shift=(2.5, -1.5), density=0.02):
    """Synthetic PIV pair: Gaussian particles, the second frame shifted by ``shift`` (u, v) px."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((2, b, h, w), np.float32)
    for i in range(b):
        n = int(density * h * w)
        xp = rng.uniform(-3, w + 3, n)
        yp = rng.uniform(-3, h + 3, n)
        sigma = rng.uniform(0.6, 1.2, n)
        peak = rng.uniform(0.5, 1.0, n)
        for f, (dx, dy) in enumerate(((0.0, 0.0), shift)):
            x, y = xp + dx, yp + dy
            for oy in range(-3, 4):
                for ox in range(-3, 4):
                    px = np.floor(x).astype(np.int64) + ox
                    py = np.floor(y).astype(np.int64) + oy
                    ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
                    val = peak * np.exp(-((px - x) ** 2 + (py - y) ** 2) / (2 * sigma ** 2))
                    np.add.at(frames[f, i], (py[ok], px[ok]), val[ok].astype(np.float32))
    frames = np.clip(frames, 0.0, 1.0)
    rgb = np.repeat(frames[..., None], 3, axis=-1)
    return rgb[0], rgb[1]


def calibration_plate(h: int, w: int, pitch: int = 40, A=None, template=(5, 25, 25),
                      noise: float = 0.0, seed: int = 0):
    """A synthetic stereo calibration plate: ``gen_template`` crosses on a square grid of
    ``pitch`` px, seen through the rational mapping ``A`` (24 coefficients, anchored at the
    image centre; None: the identity) by ``warp_image``, with Gaussian noise of ``noise`` grey
    levels. Returns the uint8 ``[h,w]`` image and the crosses' ``[N,2]`` (x, y) centres on the
    undistorted plate."""
    from piv_liteflownet_tpu_torch.stereo.dewarp import warp_image
    from piv_liteflownet_tpu_torch.stereo.matching import gen_template

    tc, hc, lc = template
    cross = gen_template(TC=tc, HC=hc, LC=lc)
    plate = np.zeros((h, w), np.uint8)
    centres = []
    for cy in range(pitch, h - pitch + 1, pitch):
        for cx in range(pitch, w - pitch + 1, pitch):
            plate[cy - hc // 2: cy - hc // 2 + hc, cx - lc // 2: cx - lc // 2 + lc] = cross
            centres.append((cx, cy))
    if A is not None:
        plate = warp_image(plate, np.array([[w / 2, h / 2]]), 0, A).numpy()
    if noise:
        rng = np.random.default_rng(seed)
        plate = np.clip(plate + noise * rng.standard_normal(plate.shape), 0, 255).astype(np.uint8)
    return plate, np.asarray(centres, np.float64)
