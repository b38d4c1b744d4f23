"""Synthetic PIV particle-image pairs on the caller's device (port of
``piv_liteflownet_tpu/data/piv_gen.py``).

Particles are uniform in (x, y, z) with a diameter d; each spot is a
Gaussian ``exp(-8 r^2 / d^2)`` of peak ``I0 * exp(-z^2 / lt^2)`` (laser-sheet
thickness ``lt``). A spot is separable, so an image is one float32 product
``(Gy * I)^T @ Gx`` with ``Gy [N,H]`` and ``Gx [N,W]``. The second frame
moves every particle by the flow sampled bilinearly at its position.

Particles are drawn on the CPU from an explicit ``torch.Generator`` and then
moved to the caller's device, so a seed gives the same particles on the CPU
and on the card; the flow fields, rendering and advection run on that device,
in full float32 whatever torch's TF32 flags say. A ``device`` of None means
the CUDA card (``models.factory.resolve_device``); the CPU is asked for with
``device="cpu"``. Torch's random stream is not JAX's: given the same
particles, the images and the advection equal JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Tuple

import torch

from piv_liteflownet_tpu_torch.models.factory import resolve_device
from piv_liteflownet_tpu_torch.ops.nn import f32_matmuls


@dataclasses.dataclass(frozen=True)
class ParticleImageGen:
    image_size: Tuple[int, int] = (256, 256)
    ppp: float = 0.02  # particles per pixel
    d_mean: float = 2.5  # mean particle image diameter (px)
    d_std: float = 0.4
    laser_thickness: float = 0.25  # as a fraction of the unit z range
    peak_intensity: float = 240.0 / 255.0  # images in [0, 1]

    @property
    def n_particles(self) -> int:
        return max(1, int(self.ppp * self.image_size[0] * self.image_size[1]))

    def sample_particles(self, generator: torch.Generator, device=None):
        """Uniform ``(x, y, z, d)`` of ``n_particles`` particles, x and y with an 8 px margin so
        that particles can move into the frame; drawn from ``generator`` (a CPU generator),
        returned on ``device`` (None: the card)."""
        h, w = self.image_size
        n = self.n_particles

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(n, generator=generator)

        x = uniform(-8.0, w + 8.0)
        y = uniform(-8.0, h + 8.0)
        z = uniform(-1.0, 1.0)
        d = torch.clamp(self.d_mean + self.d_std * torch.randn(n, generator=generator), min=1.0)
        dev = resolve_device(device)
        return tuple(t.to(dev) for t in (x, y, z, d))

    def render(self, x, y, z, d) -> torch.Tensor:
        """Splat the particles into an ``[H,W]`` image with one separable-Gaussian product."""
        h, w = self.image_size
        inten = self.peak_intensity * torch.exp(-(z ** 2) / (self.laser_thickness ** 2))
        inv = 8.0 / (d ** 2)  # PIV convention: d is the e^-2 diameter
        xs = torch.arange(w, dtype=torch.float32, device=x.device)
        ys = torch.arange(h, dtype=torch.float32, device=x.device)
        gx = torch.exp(-((xs[None, :] - x[:, None]) ** 2) * inv[:, None])  # [N, W]
        gy = torch.exp(-((ys[None, :] - y[:, None]) ** 2) * inv[:, None])  # [N, H]
        with f32_matmuls():
            img = (gy * inten[:, None]).T @ gx
        return torch.clamp(img, 0.0, 1.0)

    def _interp_flow(self, flow: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The ``[H,W,2]`` flow sampled bilinearly at the particles, positions clamped to the
        frame: ``[N,2]``."""
        h, w = flow.shape[0], flow.shape[1]
        xc = torch.clamp(x, 0.0, w - 1.0)
        yc = torch.clamp(y, 0.0, h - 1.0)
        x0 = torch.floor(xc).long()
        y0 = torch.floor(yc).long()
        x1 = torch.clamp(x0 + 1, max=w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        wx = xc - x0
        wy = yc - y0
        f = flow.reshape(h * w, 2)

        def g(yy, xx):
            return f[yy * w + xx]

        return (g(y0, x0) * ((1 - wx) * (1 - wy))[:, None]
                + g(y0, x1) * (wx * (1 - wy))[:, None]
                + g(y1, x0) * ((1 - wx) * wy)[:, None]
                + g(y1, x1) * (wx * wy)[:, None])

    def advect(self, particles, flow: torch.Tensor):
        """Both frames of given particles: float32 ``([H,W,3], [H,W,3])``, grey replicated to
        rgb, on the particles' device."""
        x, y, z, d = particles
        flow = flow.to(device=x.device, dtype=torch.float32)
        img1 = self.render(x, y, z, d)
        disp = self._interp_flow(flow, x, y)
        img2 = self.render(x + disp[:, 0], y + disp[:, 1], z, d)
        return img1[..., None].repeat(1, 1, 3), img2[..., None].repeat(1, 1, 3)

    def generate_pair(self, generator: torch.Generator, flow: torch.Tensor, device=None):
        """One pair moved by ``flow [H,W,2]``: particles from ``generator``, rendered on
        ``device`` (None: the card)."""
        return self.advect(self.sample_particles(generator, device), flow)

    def generate_batch(self, generator: torch.Generator, flows: torch.Tensor, device=None):
        """Pairs for a ``[B,H,W,2]`` flow stack, one particle draw after another, rendered on
        ``device`` (None: the card)."""
        pairs = [self.generate_pair(generator, f, device) for f in flows]
        return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


# -- flow fields, [H,W,2] float32 (u, v), on ``device`` (None: the card) -------------------

def _grid(h: int, w: int, device):
    dev = resolve_device(device)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    return ys, xs


def uniform_flow(h: int, w: int, u: float, v: float, device=None) -> torch.Tensor:
    return torch.tensor([u, v], dtype=torch.float32, device=resolve_device(device)).expand(h, w, 2).contiguous()


def vortex_flow(h: int, w: int, strength: float = 3.0, core: float = 0.25, device=None) -> torch.Tensor:
    """A Rankine-style vortex at the centre of the frame."""
    ys, xs = _grid(h, w, device)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    dx = ((xs - cx) / (w / 2)).float()
    dy = ((ys - cy) / (h / 2)).float()
    r2 = dx ** 2 + dy ** 2 + 1e-6
    scale = strength * torch.clamp(r2 / core ** 2, max=1.0) / torch.sqrt(r2)
    return torch.stack([-dy * scale, dx * scale], dim=-1)


def shear_flow(h: int, w: int, strength: float = 4.0, device=None) -> torch.Tensor:
    dev = resolve_device(device)
    ys = torch.linspace(-1, 1, h, dtype=torch.float32, device=dev)
    u = strength * ys[:, None] * torch.ones((h, w), dtype=torch.float32, device=dev)
    return torch.stack([u, torch.zeros_like(u)], dim=-1)


def sine_flow(h: int, w: int, amp: float = 2.5, freq: float = 2.0, device=None) -> torch.Tensor:
    ys, xs = _grid(h, w, device)
    u = amp * torch.sin(2 * math.pi * freq * ys / h)
    v = amp * torch.cos(2 * math.pi * freq * xs / w)
    return torch.stack([u, v], dim=-1).float()


FLOW_FIELDS: dict = {
    "uniform": lambda h, w, device=None: uniform_flow(h, w, 2.0, -1.0, device),
    "vortex": vortex_flow,
    "shear": shear_flow,
    "sine": sine_flow,
}


def make_dataset_dir(outdir: str, n: int = 16, size: Tuple[int, int] = (256, 256), seed: int = 0,
                     write_manifest: bool = True, device=None) -> None:
    """Write ``n`` synthetic pairs in the ``PIVData`` layout: ``sample_<i>_img1.png``,
    ``_img2.png`` (8-bit grey) and ``_flow.flo``, the flow fields in turn, and
    ``train.json``/``val.json`` manifests of the first 75 % and the rest. Particles come from
    ``torch.Generator().manual_seed(seed)``; the flows are built and the particles rendered on
    ``device`` (None: the card)."""
    from PIL import Image

    from piv_liteflownet_tpu_torch.utils.flow_io import write_flow

    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    gen = ParticleImageGen(image_size=tuple(size))
    generator = torch.Generator().manual_seed(seed)
    names = list(FLOW_FIELDS)
    entries = []
    for i in range(n):
        flow = FLOW_FIELDS[names[i % len(names)]](*size, device=dev)
        im1, im2 = gen.generate_pair(generator, flow, device=dev)
        base = f"sample_{i:04d}"
        for tag, im in (("img1", im1), ("img2", im2)):
            grey = (im[..., 0] * 255).to(torch.uint8).cpu().numpy()
            Image.fromarray(grey).save(os.path.join(outdir, f"{base}_{tag}.png"))
        write_flow(flow.cpu().numpy(), os.path.join(outdir, f"{base}_flow.flo"))
        entries.append(f"{base}_flow.flo")
    if write_manifest:
        n_train = max(1, int(0.75 * n))
        with open(os.path.join(outdir, "train.json"), "w") as f:
            json.dump(entries[:n_train], f)
        with open(os.path.join(outdir, "val.json"), "w") as f:
            json.dump(entries[n_train:], f)
