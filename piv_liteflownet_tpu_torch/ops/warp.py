"""Bilinear backward warp of a feature map by a dense pixel-unit flow, and its gradient.

Port of ``piv_liteflownet_tpu/ops/warp.py:backwarp`` (including ``stride``),
which is ``grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=True)`` at pixel coordinates ``(s*x + u, s*y + v)``. NCHW here:
``img [B,C,H,W]``, ``flow [B,2,ceil(H/s),ceil(W/s)]`` (u horizontal, v
vertical) -> ``[B,C,ceil(H/s),ceil(W/s)]``.

``backwarp`` launches the CUDA kernel ``csrc/backwarp.cu`` for CUDA tensors
(the port of the TPU kernel ``ops/pallas_feat_warp.py:feat_warp_pallas``;
bound by bytes, one thread per output pixel looping over channels) and takes
:func:`backwarp_plain` for CPU tensors, which autograd differentiates. On
CUDA the op is a ``torch.autograd.Function`` whose backward launches
``csrc/backwarp_bwd.cu`` (the port of the TPU warp-VJP kernel
``ops/pallas_warp_vjp.py:warp_img_grad_pallas``): the image and flow
gradients in one launch, exact for every flow and both strides.
:func:`backwarp_bwd_plain` is its plain version.
"""

from __future__ import annotations

import torch

from piv_liteflownet_tpu_torch import kernels

#: Kernel launches made by :func:`backwarp` (plain-path calls do not count).
launches = 0
#: Launches of the backward kernel, made by the backward of :func:`backwarp` on CUDA.
bwd_launches = 0


def out_hw(h: int, w: int, stride: int) -> tuple[int, int]:
    return -(-h // stride), -(-w // stride)


def _taps(img: torch.Tensor, flow: torch.Tensor, stride: int):
    """The four bilinear taps of every output pixel: ``(dy, dx, wgt_y, wgt_x, ok, idx)``.

    ``idx [B,1,h*w]`` is the flat index of the corner (clamped into the map;
    ``ok`` says whether it is really inside), the weights are per pixel.
    """
    b, _, h, w = img.shape
    ho, wo = flow.shape[2], flow.shape[3]
    xs = torch.arange(wo, device=img.device, dtype=torch.float32) * stride
    ys = torch.arange(ho, device=img.device, dtype=torch.float32) * stride
    x = xs[None, None, :] + flow[:, 0]
    y = ys[None, :, None] + flow[:, 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    taps = []
    for dy, wgt_y in ((0, 1.0 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1.0 - wx), (1, wx)):
            cx = x0 + dx
            cy = y0 + dy
            ok = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            # clamp before the integer conversion so huge coordinates stay defined
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long().reshape(b, 1, ho * wo)
            taps.append((dy, dx, wgt_y, wgt_x, ok, idx))
    return taps


def backwarp_plain(img: torch.Tensor, flow: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain PyTorch backwarp: a 4-tap bilinear gather with zeros outside the map."""
    b, c, h, w = img.shape
    ho, wo = flow.shape[2], flow.shape[3]
    flat = img.reshape(b, c, h * w)
    out = None
    for _, _, wgt_y, wgt_x, ok, idx in _taps(img, flow, stride):
        vals = flat.gather(2, idx.expand(b, c, ho * wo)).reshape(b, c, ho, wo)
        tap = vals * torch.where(ok, wgt_x * wgt_y, 0.0)[:, None]
        out = tap if out is None else out + tap
    return out


def backwarp_bwd_plain(img: torch.Tensor, flow: torch.Tensor, gout: torch.Tensor,
                       stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(g_img, g_flow)`` of :func:`backwarp_plain` for the output gradient ``gout``.

    The explicit formula, as ``csrc/backwarp_bwd.cu`` computes it: each tap
    scatters ``gout * weight`` onto the pixel it read; ``g_flow`` sums over
    the channels ``gout`` times the derivative of the sample, in which floor
    has zero derivative and taps outside the map read zero.
    """
    b, c, h, w = img.shape
    ho, wo = flow.shape[2], flow.shape[3]
    flat = img.reshape(b, c, h * w)
    g_img = torch.zeros_like(flat)
    g_u = torch.zeros((b, ho, wo), device=img.device, dtype=img.dtype)
    g_v = torch.zeros_like(g_u)
    for dy, dx, wgt_y, wgt_x, ok, idx in _taps(img, flow, stride):
        okf = ok.to(img.dtype)
        vals = flat.gather(2, idx.expand(b, c, ho * wo)).reshape(b, c, ho, wo)
        g_img.scatter_add_(2, idx.expand(b, c, ho * wo),
                           (gout * (okf * wgt_x * wgt_y)[:, None]).reshape(b, c, ho * wo))
        gv_sum = (gout * vals).sum(1) * okf  # sum_c gout * tap value
        g_u += gv_sum * (wgt_y if dx else -wgt_y)
        g_v += gv_sum * (wgt_x if dy else -wgt_x)
    return g_img.reshape(b, c, h, w), torch.stack([g_u, g_v], 1)


class _Backwarp(torch.autograd.Function):
    """The kernel path: ``csrc/backwarp.cu`` forward, ``csrc/backwarp_bwd.cu`` backward."""

    @staticmethod
    def forward(ctx, img, flow, stride):
        global launches
        b, c = img.shape[:2]
        out = torch.empty((b, c, *flow.shape[2:]), device=img.device, dtype=img.dtype)
        ctx.stride = stride
        ctx.save_for_backward(img, flow)
        if out.numel():
            _launch(img, flow, stride, out)
            launches += 1
        return out

    @staticmethod
    def backward(ctx, gout):
        global bwd_launches
        img, flow = ctx.saved_tensors
        gout = gout.contiguous()
        g_img = torch.empty_like(img)
        g_flow = torch.empty_like(flow)
        kernels.on_cuda("backwarp_bwd", img, flow, gout, g_img, g_flow)
        if gout.numel():  # empty only when img is empty too
            _launch_bwd(img, flow, gout, ctx.stride, g_img, g_flow)
            bwd_launches += 1
        return g_img, g_flow, None


def backwarp(img: torch.Tensor, flow: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Backwarp ``img`` by ``flow`` on the stride-``stride`` grid; kernel on CUDA, plain version on the CPU.

    Differentiable in ``img`` and ``flow`` on both paths.
    """
    if img.dim() != 4 or flow.dim() != 4:
        raise ValueError("backwarp: img and flow must be [B,C,H,W] and [B,2,h,w]")
    b, c, h, w = img.shape
    ho, wo = out_hw(h, w, stride)
    if stride not in (1, 2) or tuple(flow.shape) != (b, 2, ho, wo):
        raise ValueError(f"backwarp: flow {tuple(flow.shape)} does not fit img "
                         f"{tuple(img.shape)} at stride {stride} (stride 1 or 2)")
    if not kernels.on_cuda("backwarp", img, flow):
        return backwarp_plain(img, flow, stride)
    return _Backwarp.apply(img, flow, stride)


def _launch(img: torch.Tensor, flow: torch.Tensor, stride: int, out: torch.Tensor) -> None:
    """The kernel call itself (a test can substitute a fake)."""
    b, c, h, w = img.shape
    kernels.launch("pivk_backwarp_f32", "backwarp", img.device,
                   img.data_ptr(), flow.data_ptr(), out.data_ptr(),
                   b, c, h, w, out.shape[2], out.shape[3], stride)


def _launch_bwd(img: torch.Tensor, flow: torch.Tensor, gout: torch.Tensor, stride: int,
                g_img: torch.Tensor, g_flow: torch.Tensor) -> None:
    """The backward kernel call itself (a test can substitute a fake); it overwrites both outputs."""
    b, c, h, w = img.shape
    kernels.launch("pivk_backwarp_bwd_f32", "backwarp_bwd", img.device,
                   img.data_ptr(), flow.data_ptr(), gout.data_ptr(), g_img.data_ptr(),
                   g_flow.data_ptr(), b, c, h, w, gout.shape[2], gout.shape[3], stride)
