"""Plain PyTorch versions of the model's custom ops, NCHW, written for the reference alone.

Every op works in its operands' dtype and is differentiated by autograd. None of them
calls a kernel; the reference runs them in float32 with the TF32 flags off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEGATIVE_SLOPE = 0.1
MD = 3  # the cost volume's reach: a 7x7 window, 49 displacements


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, NEGATIVE_SLOPE)


def corr49(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """``out[b, (dy+3)*7 + dx+3, y, x] = mean_c f1[b,c,y,x] * f2[b,c,y+dy,x+dx]``, zeros outside."""
    b, c, h, w = f1.shape
    f2p = F.pad(f2, (MD, MD, MD, MD))
    taps = [(f1 * f2p[:, :, dy:dy + h, dx:dx + w]).mean(1)
            for dy in range(2 * MD + 1) for dx in range(2 * MD + 1)]
    return torch.stack(taps, 1)


def backwarp(img: torch.Tensor, flow: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Bilinear sample of ``img [B,C,H,W]`` at pixel ``(stride*x + u, stride*y + v)`` of each
    output pixel of ``flow [B,2,h,w]``; a tap outside the map reads 0 (``grid_sample`` with
    ``align_corners=True`` and zero padding)."""
    b, c, h, w = img.shape
    ho, wo = flow.shape[2], flow.shape[3]
    xs = torch.arange(wo, device=img.device, dtype=torch.float32) * stride
    ys = torch.arange(ho, device=img.device, dtype=torch.float32) * stride
    x = xs.view(1, 1, wo) + flow[:, 0].float()
    y = ys.view(1, ho, 1) + flow[:, 1].float()
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = img.reshape(b, c, h * w)
    out = 0.0
    for cy, wy in ((y0, 1.0 - fy), (y0 + 1.0, fy)):
        for cx, wx in ((x0, 1.0 - fx), (x0 + 1.0, fx)):
            inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long().view(b, 1, ho * wo)
            vals = flat.gather(2, idx.expand(b, c, ho * wo)).view(b, c, ho, wo)
            out = out + vals * torch.where(inside, wx * wy, torch.zeros_like(wx))[:, None].to(img.dtype)
    return out


def rgb_warp_norm(img1: torch.Tensor, img2: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``sqrt(sum_c (img1 - backwarp(img2, flow))^2)`` as ``[B,1,H,W]``, without a gradient."""
    with torch.no_grad():
        d = img1 - backwarp(img2, flow)
        return torch.sqrt((d * d).sum(1, keepdim=True))


def deconv4x2(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The depthwise ``ConvTranspose2d(C, C, 4, stride=2, padding=1, groups=C)``."""
    return F.conv_transpose2d(x, weight, stride=2, padding=1, groups=x.shape[1])


def unfold(x: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k*k`` zero-padded patches of a ``[B,1,H,W]`` map as ``[B,k*k,H,W]``."""
    b, _, h, w = x.shape
    return F.unfold(x, k, padding=(k - 1) // 2).view(b, k * k, h, w)


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize, half-pixel centres, no antialiasing; the identity at the same size."""
    if tuple(x.shape[-2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return x if k == 1 else F.avg_pool2d(x, k, k)
