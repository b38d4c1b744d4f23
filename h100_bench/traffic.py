"""The benchmark's one traffic generator: synthetic PIV particle-image pairs rendered on the
device from a seed, and the pools of pairs that the drivers stream.

A traffic file (``traffic/<name>.json``) gives the frame size, the pool, the batch and the
flow families with their amplitudes. Every seed gets the same amplitudes, the same number of
pairs of each family and the same particle density; the seed draws the particles, each
flow's direction, centre and phase, and the order of the pairs. So two seeds ask the same
work of the program, in another order and on other particles.

The renderer follows the usual synthetic-PIV recipe (a frozen copy of the program's
``data/piv_gen.py``): particles uniform in (x, y, z), each a Gaussian spot
``exp(-8 r^2 / d^2)`` of peak ``I0 exp(-z^2 / lt^2)``, an image one float32 product
``(Gy * I)^T @ Gx``; the second frame moves every particle by the flow sampled bilinearly at
its position.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

PPP = 0.02            # particles per pixel
D_MEAN, D_STD = 2.5, 0.4  # particle image diameter (px)
LASER = 0.25          # laser-sheet thickness, a fraction of the unit z range
PEAK = 240.0 / 255.0  # a particle's peak intensity, images in [0, 1]


def rng(seed: int, salt: int) -> np.random.Generator:
    """The numpy generator of ``seed`` (any whole number) for one purpose, ``salt``."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), salt])


def _render(x, y, z, d, h: int, w: int) -> torch.Tensor:
    inten = PEAK * torch.exp(-(z ** 2) / LASER ** 2)
    inv = 8.0 / d ** 2
    xs = torch.arange(w, dtype=torch.float32, device=x.device)
    ys = torch.arange(h, dtype=torch.float32, device=x.device)
    gx = torch.exp(-((xs[None, :] - x[:, None]) ** 2) * inv[:, None])
    gy = torch.exp(-((ys[None, :] - y[:, None]) ** 2) * inv[:, None])
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        img = (gy * inten[:, None]).T @ gx
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return img.clamp(0.0, 1.0)


def _at(flow: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The ``[H,W,2]`` flow bilinearly at the particles (clamped to the frame): ``[N,2]``."""
    h, w = flow.shape[:2]
    xc, yc = x.clamp(0.0, w - 1.0), y.clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(xc).long(), torch.floor(yc).long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    fx, fy = (xc - x0)[:, None], (yc - y0)[:, None]
    return (flow[y0, x0] * (1 - fx) * (1 - fy) + flow[y0, x1] * fx * (1 - fy)
            + flow[y1, x0] * (1 - fx) * fy + flow[y1, x1] * fx * fy)


def render_pair(flow: torch.Tensor, g: np.random.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both frames ``[H,W,3]`` (grey in all three channels) of particles drawn from ``g``,
    the second moved by ``flow [H,W,2]``, on the flow's device."""
    h, w = flow.shape[:2]
    n = max(1, int(PPP * h * w))
    dev = flow.device
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x, y = t(g.uniform(-8.0, w + 8.0, n)), t(g.uniform(-8.0, h + 8.0, n))
    z, d = t(g.uniform(-1.0, 1.0, n)), t(np.maximum(D_MEAN + D_STD * g.standard_normal(n), 1.0))
    disp = _at(flow, x, y)
    im1 = _render(x, y, z, d, h, w)
    im2 = _render(x + disp[:, 0], y + disp[:, 1], z, d, h, w)
    return im1[..., None].expand(h, w, 3), im2[..., None].expand(h, w, 3)


def flow_field(family: str, amp: float, h: int, w: int, g: np.random.Generator, device) -> torch.Tensor:
    """``[H,W,2]`` float32 (u, v) of a family; ``amp`` is its largest displacement in px."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    if family == "uniform":
        a = g.uniform(0, 2 * math.pi)
        return torch.stack([torch.full_like(xs, amp * math.cos(a)), torch.full_like(xs, amp * math.sin(a))], -1)
    if family == "vortex":  # a Rankine vortex: solid rotation inside the core, 1/r outside
        cx, cy = g.uniform(0.3, 0.7) * (w - 1), g.uniform(0.3, 0.7) * (h - 1)
        core = 0.25 * min(h, w)
        dx, dy = xs - cx, ys - cy
        r = torch.sqrt(dx * dx + dy * dy) + 1e-6
        speed = amp * torch.where(r < core, r / core, core / r)
        sign = 1.0 if g.uniform() < 0.5 else -1.0
        return torch.stack([-sign * dy / r * speed, sign * dx / r * speed], -1)
    if family == "shear":
        a = g.uniform(0, 2 * math.pi)
        s = (ys / max(h - 1, 1)) * 2.0 - 1.0 if g.uniform() < 0.5 else (xs / max(w - 1, 1)) * 2.0 - 1.0
        return torch.stack([amp * s * math.cos(a), amp * s * math.sin(a)], -1)
    if family == "sine":
        pu, pv = g.uniform(0, 2 * math.pi, 2)
        freq = 2.0
        u = torch.sin(2 * math.pi * freq * ys / h + pu)
        v = torch.cos(2 * math.pi * freq * xs / w + pv)
        return amp / math.sqrt(2.0) * torch.stack([u, v], -1)
    raise ValueError(f"unknown flow family {family!r}")


def pool(traffic: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The traffic's pool: ``img1, img2 [N,H,W,3]`` and ``flow [N,H,W,2]`` float32 on
    ``device``, the pairs in an order drawn from the seed.

    ``traffic["pool"]`` pairs are split evenly over ``traffic["families"]``; within a family
    the amplitudes run evenly over ``traffic["amp_px"]`` (lowest, highest)."""
    h, w = traffic["size"]
    n = int(traffic["pool"])
    fams: List[str] = list(traffic["families"])
    lo, hi = traffic["amp_px"]
    per = n // len(fams)
    if per * len(fams) != n:
        raise ValueError(f"a pool of {n} does not split over {len(fams)} families")
    jobs = [(f, lo + (hi - lo) * (k / max(per - 1, 1))) for f in fams for k in range(per)]
    g = rng(seed, 1)
    order = g.permutation(n)
    out = {k: torch.empty((n, h, w, c), dtype=torch.float32, device=device)
           for k, c in (("img1", 3), ("img2", 3), ("flow", 2))}
    for slot, j in enumerate(order):
        fam, amp = jobs[j]
        f = flow_field(fam, amp, h, w, g, device)
        out["img1"][slot], out["img2"][slot] = render_pair(f, g)
        out["flow"][slot] = f
    return out
