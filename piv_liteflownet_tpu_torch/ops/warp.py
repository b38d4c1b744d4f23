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
gradients in one launch, exact for every flow and both strides: a tile of
output pixels whose taps fit a shared-memory window (:func:`tile_windows`)
reduces them there and flushes the window with vector reductions, any other
tile scatters with global atomics and is counted in
:func:`out_of_window_counter`. :func:`backwarp_bwd_plain` is its plain
version.

Both paths keep the map's dtype, float32 or bfloat16, as the JAX function
does: sample points, floors and the validity test are float32, the bilinear
weights are cast to the map's dtype. The kernel's bf16 form
(``pivk_backwarp_bf16``) computes weights and sums in float32 and rounds once
on store. bf16 has no backward kernel yet: its backward raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from piv_liteflownet_tpu_torch import kernels

#: Kernel launches made by :func:`backwarp` (plain-path calls do not count): the float32 form.
launches = 0
#: Launches of the kernel's bfloat16 form.
bf16_launches = 0
#: Launches of the backward kernel, made by the backward of :func:`backwarp` on CUDA.
bwd_launches = 0

#: The backward kernel's tile of output pixels, (width, height): one warp's, a lane each.
TILE_W, TILE_H = 32, 1
#: The float4 that a tile's shared-memory window holds (``CAP`` in ``csrc/backwarp_bwd.cu``):
#: its footprint's rows times its columns of 4, counted from x0, must not exceed it.
WINDOW_VEC4 = 352


def out_hw(h: int, w: int, stride: int) -> tuple[int, int]:
    return -(-h // stride), -(-w // stride)


def _corners(flow: torch.Tensor, stride: int):
    """Sample points ``x, y [B,h,w]`` (pixels, float32) and their floors ``x0, y0``."""
    ho, wo = flow.shape[2], flow.shape[3]
    xs = torch.arange(wo, device=flow.device, dtype=torch.float32) * stride
    ys = torch.arange(ho, device=flow.device, dtype=torch.float32) * stride
    x = xs[None, None, :] + flow[:, 0]
    y = ys[None, :, None] + flow[:, 1]
    return x, y, torch.floor(x), torch.floor(y)


def _taps(img: torch.Tensor, flow: torch.Tensor, stride: int):
    """The four bilinear taps of every output pixel: ``(dy, dx, wgt_y, wgt_x, ok, idx)``.

    ``idx [B,1,h*w]`` is the flat index of the corner (clamped into the map;
    ``ok`` says whether it is really inside), the weights are per pixel, in the map's dtype
    (the fractions taken in float32, then cast, as JAX ``gather_warp`` does).
    """
    b, _, h, w = img.shape
    ho, wo = flow.shape[2], flow.shape[3]
    x, y, x0, y0 = _corners(flow, stride)
    wx = (x - x0).to(img.dtype)
    wy = (y - y0).to(img.dtype)
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
    """Plain PyTorch backwarp: a 4-tap bilinear gather with zeros outside the map, in ``img``'s dtype."""
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


class TileWindows(NamedTuple):
    """Per tile ``[B, ceil(h/TILE_H), ceil(w/TILE_W)]`` of the backward kernel (int64, bool)."""

    x0: torch.Tensor      # window origin: min x of the taps, rounded down to a multiple of 4
    y0: torch.Tensor      # min y of the taps
    width: torch.Tensor   # max x - x0 + 1; 0 where no tap of the tile lies inside the map
    height: torch.Tensor  # max y - y0 + 1; 0 there too
    fits: torch.Tensor    # the window path: ceil(width / 4) * height <= WINDOW_VEC4


def tile_windows(flow: torch.Tensor, h: int, w: int, stride: int) -> TileWindows:
    """The tile rule of ``csrc/backwarp_bwd.cu``: each tile's footprint and whether it fits.

    A tile is ``TILE_W x TILE_H`` output pixels; its footprint is the bounding box of
    the taps of its pixels that lie inside the ``h x w`` map. The kernel reduces a
    tile that fits ``WINDOW_VEC4`` in shared memory and scatters any other
    tile with global atomics; a tile with no tap inside fits.
    """
    b, _, ho, wo = flow.shape
    nty, ntx = -(-ho // TILE_H), -(-wo // TILE_W)
    _, _, x0, y0 = _corners(flow, stride)
    cx = torch.stack([x0, x0 + 1, x0, x0 + 1])  # the four taps, as in _taps
    cy = torch.stack([y0, y0, y0 + 1, y0 + 1])
    ok = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)

    def per_tile(v, fill, reduce):  # over the taps inside the map of each tile's pixels
        t = torch.full((4, b, nty * TILE_H, ntx * TILE_W), fill, device=flow.device)
        t[:, :, :ho, :wo] = torch.where(ok, v, fill)
        return reduce(t.reshape(4, b, nty, TILE_H, ntx, TILE_W), dim=(0, 3, 5))

    inf = float("inf")
    xmin, xmax = per_tile(cx, inf, torch.amin), per_tile(cx, -inf, torch.amax)
    ymin, ymax = per_tile(cy, inf, torch.amin), per_tile(cy, -inf, torch.amax)
    empty = torch.isinf(xmin)
    wx0 = torch.where(empty, 0.0, torch.floor(xmin / 4) * 4)
    wy0 = torch.where(empty, 0.0, ymin)
    width = torch.where(empty, 0.0, xmax - wx0 + 1)
    height = torch.where(empty, 0.0, ymax - wy0 + 1)
    fits = torch.div(width + 3, 4, rounding_mode="floor") * height <= WINDOW_VEC4
    return TileWindows(wx0.long(), wy0.long(), width.long(), height.long(), fits)


def out_of_window_tiles(flow: torch.Tensor, h: int, w: int, stride: int) -> int:
    """How many tiles :func:`tile_windows` sends down the kernel's global-atomic path."""
    return int((~tile_windows(flow, h, w, stride).fits).sum())


def out_of_window_counter(device: torch.device) -> torch.Tensor:
    """The backward kernel's running count (int32, on ``device``) of tiles that took the
    global-atomic path; a caller zeroes it to count over a stretch of launches."""
    return kernels.device_counter("backwarp_bwd out of window", device)


class _Backwarp(torch.autograd.Function):
    """The kernel path: ``csrc/backwarp.cu`` forward, ``csrc/backwarp_bwd.cu`` backward."""

    @staticmethod
    def forward(ctx, img, flow, stride):
        global launches, bf16_launches
        b, c = img.shape[:2]
        out = torch.empty((b, c, *flow.shape[2:]), device=img.device, dtype=img.dtype)
        ctx.stride = stride
        ctx.save_for_backward(img, flow)
        if out.numel():
            _launch(img, flow, stride, out)
            if img.dtype == torch.bfloat16:
                bf16_launches += 1
            else:
                launches += 1
        return out

    @staticmethod
    def backward(ctx, gout):
        global bwd_launches
        img, flow = ctx.saved_tensors
        if img.dtype == torch.bfloat16:
            raise NotImplementedError(
                "backwarp has no bfloat16 backward kernel yet: bf16 training comes with the "
                "bf16 backward kernels (ROADMAP.md, Queue 2 item 1)")
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

    Both float32 or both bfloat16; the result has their dtype. Differentiable in ``img`` and
    ``flow`` on both paths in float32; on CUDA a bfloat16 backward raises.
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
    kernels.launch(kernels.entry("backwarp", img.dtype), "backwarp", img.device,
                   img.data_ptr(), flow.data_ptr(), out.data_ptr(),
                   b, c, h, w, out.shape[2], out.shape[3], stride)


def _launch_bwd(img: torch.Tensor, flow: torch.Tensor, gout: torch.Tensor, stride: int,
                g_img: torch.Tensor, g_flow: torch.Tensor) -> None:
    """The backward kernel call itself (a test can substitute a fake); it overwrites both
    outputs and adds its out-of-window tiles to :func:`out_of_window_counter`."""
    b, c, h, w = img.shape
    kernels.launch("pivk_backwarp_bwd_f32", "backwarp_bwd", img.device,
                   img.data_ptr(), flow.data_ptr(), gout.data_ptr(), g_img.data_ptr(),
                   g_flow.data_ptr(), out_of_window_counter(img.device).data_ptr(),
                   b, c, h, w, gout.shape[2], gout.shape[3], stride)
