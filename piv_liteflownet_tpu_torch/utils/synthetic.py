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
