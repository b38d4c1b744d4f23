"""The reference's training steps: the default augmentation, the piv loss, the gradient by
autograd through the plain ops, and Adam over the four parameter groups.

- Augmentation (the fine-tuning recipe of PIV-LiteFlowNet-en's trainer): translate by up to
  16 % (the two frames oppositely), scale 0.95-1.45, both flips with probability 1/2, a
  random crop; then per sample contrast, brightness, colour, gamma and Gaussian noise. The
  factors are drawn from a ``torch.Generator`` on the frames' device seeded with the step's
  seed, in the trainer's order, so that the same seed gives the same factors. Each frame and
  the flow are sampled once, four bilinear taps at the crop's coordinates.
- The piv loss of Cai et al. 2019: the target divided by 5, each level's three flows against
  the target average-pooled to its size, an L1 mean weighted 0.001 per level and 0.01 at
  the finest.
- Adam (betas 0.9 and 0.999, eps 1e-8), L2 decay added to the gradient: ``w_lo`` and
  ``b_lo`` are the NetE modules below level 4, at the low rate; the rest at the high one.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from h100_bench.reference import ops
from h100_bench.reference.model import Net

# the trainer's default augmentation
TRANSLATE = 16
SCALE = (0.95, 1.45)
NOISE_STD = (0.0, 0.04)
CONTRAST = (-0.8, 0.4)
BRIGHTNESS_SIGMA = 0.2
COLOR = (0.5, 2.0)
GAMMA = (0.7, 1.5)


def draw(b: int, h: int, w: int, crop: Sequence[int], gen: torch.Generator) -> Dict[str, torch.Tensor]:
    dev = gen.device
    ch, cw = crop

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((b,) + shape, generator=gen, device=dev)

    tw = torch.floor(uniform(-TRANSLATE, TRANSLATE) * w / 100.0)
    th = torch.floor(uniform(-TRANSLATE, TRANSLATE) * h / 100.0)
    s = uniform(*SCALE)
    fh = uniform(0.0, 1.0) < 0.5
    fv = uniform(0.0, 1.0) < 0.5
    ox = uniform(0.0, 1.0) * torch.clamp((w - tw.abs()) * s - cw, min=0.0)
    oy = uniform(0.0, 1.0) * torch.clamp((h - th.abs()) * s - ch, min=0.0)
    contrast = uniform(*CONTRAST)
    gamma = uniform(*GAMMA)
    color = uniform(*COLOR, 3)
    brightness = torch.randn(b, generator=gen, device=dev) * BRIGHTNESS_SIGMA
    noise_std = uniform(*NOISE_STD)
    noise = torch.randn((b, 2, ch, cw, 3), generator=gen, device=dev)
    return dict(tw=tw, th=th, s=s, fh=fh, fv=fv, ox=ox, oy=oy, contrast=contrast, gamma=gamma,
                color=color, brightness=brightness, noise_std=noise_std, noise=noise)


def _sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``img [B,H,W,C]`` at ``x, y [B,h,w]``, clamped to the frame, four bilinear taps."""
    b, h, w, _ = img.shape
    x = x.clamp(0.0, w - 1.0)
    y = y.clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    bi = torch.arange(b, device=img.device).view(b, 1, 1)
    return (img[bi, y0, x0] * (1 - fx) * (1 - fy) + img[bi, y0, x1] * fx * (1 - fy)
            + img[bi, y1, x0] * (1 - fx) * fy + img[bi, y1, x1] * fx * fy)


def augment(img1, img2, flow, seed: int, crop: Sequence[int]):
    """The augmented, cropped ``[B,ch,cw,3]`` frames and ``[B,ch,cw,2]`` flow of one step."""
    b, h, w = img1.shape[:3]
    ch, cw = crop
    gen = torch.Generator(device=img1.device).manual_seed(int(seed))
    p = draw(b, h, w, crop, gen)
    dev = img1.device
    col = lambda v: v.view(b, 1, 1)  # noqa: E731
    xo = torch.arange(cw, dtype=torch.float32, device=dev).view(1, 1, cw).expand(b, ch, cw)
    yo = torch.arange(ch, dtype=torch.float32, device=dev).view(1, ch, 1).expand(b, ch, cw)
    xo = torch.where(col(p["fh"]), cw - 1.0 - xo, xo)
    yo = torch.where(col(p["fv"]), ch - 1.0 - yo, yo)
    xs = (xo + col(p["ox"]) + 0.5) / col(p["s"]) - 0.5
    ys = (yo + col(p["oy"]) + 0.5) / col(p["s"]) - 0.5
    tw, th = col(p["tw"]), col(p["th"])
    out1 = _sample(img1, xs + tw.clamp(min=0), ys + th.clamp(min=0))
    f = _sample(flow, xs + tw.clamp(min=0), ys + th.clamp(min=0))
    out2 = _sample(img2, xs + (-tw).clamp(min=0), ys + (-th).clamp(min=0))
    f = (f + torch.stack([p["tw"], p["th"]], -1).view(b, 1, 1, 2)) * p["s"].view(b, 1, 1, 1)
    signs = torch.stack([torch.where(p["fh"], -1.0, 1.0), torch.where(p["fv"], -1.0, 1.0)], -1)
    f = f * signs.view(b, 1, 1, 2)
    c4 = lambda v: v.view(b, 1, 1, -1)  # noqa: E731

    def photo(im, i):
        im = torch.clamp((im * (c4(p["contrast"]) + 1.0) + c4(p["brightness"])) * c4(p["color"]), 0.0, 1.0)
        return torch.pow(im, 1.0 / c4(p["gamma"])) + p["noise"][:, i] * c4(p["noise_std"])

    return photo(out1, 0), photo(out2, 1), f


def piv_loss(outs: List[List[torch.Tensor]], target: torch.Tensor, version: int) -> torch.Tensor:
    """``target [B,2,H,W]``; ``outs`` the train forward's levels, coarsest first."""
    weights = (0.001,) * 5 + (0.01,) if version == 1 else (0.001,) * 4 + (0.01, 0.01)
    start = version if version == 1 else 2
    n_scales = 7 - start
    target = target / 5.0
    loss = 0.0
    for i, flows in enumerate(outs):
        t = ops.avg_pool(target, start * 2 ** (n_scales - 1 - i)) if i < n_scales else target
        for f in flows:
            loss = loss + weights[i] * (f - t).abs().mean()
    return loss


def group_of(name: str, lowest_level: int) -> str:
    """``w_lo``, ``w_hi``, ``b_lo`` or ``b_hi``: NetE modules of a level below 4 are low."""
    parts = name.split(".")
    low = parts[0].startswith("NetE") and int(parts[1]) + lowest_level < 4
    return ("b" if parts[-1] == "bias" else "w") + ("_lo" if low else "_hi")


def steps(params0: Dict[str, torch.Tensor], model: dict, batches, seeds: Sequence[int], crop,
          optim: dict, tf32: bool = False, rows: slice = slice(None)) -> dict:
    """Run the steps of ``batches`` (``(img1, img2, flow)``, NHWC float32 on the device) from
    ``params0``; returns each step's loss, each leaf's first gradient as Adam receives it
    (the decay added) and each leaf's change after the last step.

    ``tf32`` runs the convs and matmuls in TF32 (the control); ``rows`` keeps those rows of
    each augmented batch (a fault of the benchmark's tests)."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        p = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
        net = Net(p, model)
        lowest = int(model["lowest_level"])
        b1, b2 = optim["betas"]
        eps = optim["eps"]
        lr = {g: optim["lr_" + g[-2:]] for g in ("w_lo", "w_hi", "b_lo", "b_hi")}
        wd = {g: optim["weight_decay"] if g[0] == "w" else optim["bias_decay"] for g in lr}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, first = [], {}
        for t, ((im1, im2, fl), seed) in enumerate(zip(batches, seeds), start=1):
            a1, a2, f = augment(im1, im2, fl, seed, crop)
            a1, a2, f = a1[rows], a2[rows], f[rows]
            outs = net.forward(a1.permute(0, 3, 1, 2), a2.permute(0, 3, 1, 2), train=True)
            loss = piv_loss(outs, f.permute(0, 3, 1, 2), net.version)
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for (k, x), g in zip(p.items(), grads):
                    grp = group_of(k, lowest)
                    g = g + wd[grp] * x
                    if t == 1:
                        first[k] = float(torch.linalg.vector_norm(g))
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                    x.addcdiv_(m[k], denom, value=-lr[grp] / (1 - b1 ** t))
        change = {k: float(torch.linalg.vector_norm(p[k].detach() - params0[k].float())) for k in p}
        return {"losses": losses, "grad": first, "change": change}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
