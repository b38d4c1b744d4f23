"""Bilinear backward warp of a feature map by a dense pixel-unit flow.

Port of ``piv_liteflownet_tpu/ops/warp.py:backwarp`` (including ``stride``),
which is ``grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=True)`` at pixel coordinates ``(s*x + u, s*y + v)``. NCHW here:
``img [B,C,H,W]``, ``flow [B,2,ceil(H/s),ceil(W/s)]`` (u horizontal, v
vertical) -> ``[B,C,ceil(H/s),ceil(W/s)]``.

``backwarp`` launches the CUDA kernel ``csrc/backwarp.cu`` for CUDA tensors
(the port of the TPU kernel ``ops/pallas_feat_warp.py:feat_warp_pallas``;
bound by bytes, one thread per output pixel looping over channels) and takes
:func:`backwarp_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from piv_liteflownet_tpu_torch import kernels

#: Kernel launches made by :func:`backwarp` (plain-path calls do not count).
launches = 0


def out_hw(h: int, w: int, stride: int) -> tuple[int, int]:
    return -(-h // stride), -(-w // stride)


def backwarp_plain(img: torch.Tensor, flow: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain PyTorch backwarp: a 4-tap bilinear gather with zeros outside the map."""
    b, c, h, w = img.shape
    ho, wo = flow.shape[2], flow.shape[3]
    xs = torch.arange(wo, device=img.device, dtype=torch.float32) * stride
    ys = torch.arange(ho, device=img.device, dtype=torch.float32) * stride
    x = xs[None, None, :] + flow[:, 0]
    y = ys[None, :, None] + flow[:, 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    flat = img.reshape(b, c, h * w)
    out = None
    for dy, wgt_y in ((0, 1.0 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1.0 - wx), (1, wx)):
            cx = x0 + dx
            cy = y0 + dy
            ok = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            # clamp before the integer conversion so huge coordinates stay defined
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long().reshape(b, 1, ho * wo)
            vals = flat.gather(2, idx.expand(b, c, ho * wo)).reshape(b, c, ho, wo)
            tap = vals * torch.where(ok, wgt_x * wgt_y, 0.0)[:, None]
            out = tap if out is None else out + tap
    return out


def backwarp(img: torch.Tensor, flow: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Backwarp ``img`` by ``flow`` on the stride-``stride`` grid; kernel on CUDA, plain version on the CPU."""
    if img.dim() != 4 or flow.dim() != 4:
        raise ValueError("backwarp: img and flow must be [B,C,H,W] and [B,2,h,w]")
    b, c, h, w = img.shape
    ho, wo = out_hw(h, w, stride)
    if stride not in (1, 2) or tuple(flow.shape) != (b, 2, ho, wo):
        raise ValueError(f"backwarp: flow {tuple(flow.shape)} does not fit img "
                         f"{tuple(img.shape)} at stride {stride} (stride 1 or 2)")
    if not kernels.on_cuda("backwarp", img, flow):
        return backwarp_plain(img, flow, stride)
    global launches
    out = torch.empty((b, c, ho, wo), device=img.device, dtype=img.dtype)
    if out.numel() == 0:
        return out
    _launch(img, flow, stride, out)
    launches += 1
    return out


def _launch(img: torch.Tensor, flow: torch.Tensor, stride: int, out: torch.Tensor) -> None:
    """The kernel call itself (a test can substitute a fake)."""
    b, c, h, w = img.shape
    kernels.launch("pivk_backwarp_f32", "backwarp", img.device,
                   img.data_ptr(), flow.data_ptr(), out.data_ptr(),
                   b, c, h, w, out.shape[2], out.shape[3], stride)
