"""Bilinear backward warp of a feature map by a dense pixel-unit flow, and its gradient.

Port of ``piv_liteflownet_tpu/ops/warp.py:backwarp`` (including ``stride``),
which is ``grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=True)`` at pixel coordinates ``(s*x + u, s*y + v)``. NCHW here:
``img [B,C,H,W]``, ``flow [B,2,ceil(H/s),ceil(W/s)]`` (u horizontal, v
vertical) -> ``[B,C,ceil(H/s),ceil(W/s)]``. The forward also takes a slab
(``ops/halo_warp.py``): an image taller than the output grid, whose rows
start at the image's row ``row0`` (pixel coordinates ``(s*x + u, s*y + row0
+ v)``); the flow's rows are then any count, its columns still ``ceil(W/s)``.

``backwarp`` launches the CUDA kernel ``csrc/backwarp.cu`` for CUDA tensors
(the port of the TPU kernel ``ops/pallas_feat_warp.py:feat_warp_pallas``;
bound by bytes; the float32 form one thread per output pixel looping over
channels, the bf16 form staging each tile of ``STAGED_TILE`` output pixels'
footprint rows in shared memory, 4 channels at a time, where it fits
(:func:`staged_tiles`; a tile that does not gathers directly and is counted in
:func:`direct_tile_counter`)) and takes :func:`backwarp_plain` for CPU
tensors, which autograd differentiates. On CUDA the op is a
``torch.autograd.Function`` whose backward launches ``csrc/backwarp_bwd.cu``
(the port of the TPU warp-VJP kernel
``ops/pallas_warp_vjp.py:warp_img_grad_pallas``): the image and flow
gradients, exact for every flow and both strides. Its float32 form reduces a
tile of output pixels whose taps fit a shared-memory window
(:func:`tile_windows`) there and flushes the window with vector reductions;
any other tile scatters with global atomics and is counted in
:func:`out_of_window_counter`. Its bf16 form gives every element of the image
gradient one owner: a block per rectangle of ``OWNER_W x OWNER_H`` pixels
sums in float32, in an order set by the flow, the taps that land in it of the
output pixels of its candidate box (:func:`owner_rects`, found by a pre-pass
over the flow), rounds once and stores, so that both gradients are
bit-deterministic; a rectangle with more than ``OWNER_CAP`` candidates or
``OWNER_KMAX`` taps on one element takes a slower path and is counted in
:func:`slow_rect_counter`. :func:`backwarp_bwd_plain` is the plain version of
both.

Both paths keep the map's dtype, float32 or bfloat16, as the JAX function
does: sample points, floors and the validity test are float32, the bilinear
weights are cast to the map's dtype. The kernels' bf16 forms
(``pivk_backwarp_bf16``, ``pivk_backwarp_bwd_bf16``) compute weights and sums
in float32 and round each output once on store. On the CPU the bf16 backward
is autograd through :func:`backwarp_plain` in bf16.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from piv_liteflownet_tpu_torch import kernels

#: Kernel launches made by :func:`backwarp` (plain-path calls do not count): the float32 form.
launches = 0
#: Launches of the kernel's bfloat16 form.
bf16_launches = 0
#: Launches of the backward kernel, made by the backward of :func:`backwarp` on CUDA: the float32 form.
bwd_launches = 0
#: Launches of the backward kernel's bfloat16 form.
bwd_bf16_launches = 0

#: The backward kernel's tile of output pixels, (width, height): one warp's, a lane each.
TILE_W, TILE_H = 32, 1
#: The float4 that a tile's shared-memory window holds (``CAP`` in ``csrc/backwarp_bwd.cu``):
#: its footprint's rows times its columns of 4, counted from x0, must not exceed it.
WINDOW_VEC4 = 352
#: The bf16 backward's owner rectangle of the image gradient, (width, height) in pixels
#: (``own::RW``, ``own::RH`` in ``csrc/backwarp_bwd.cu``).
OWNER_W, OWNER_H = 32, 8
#: The candidates (output pixels with a tap in the rectangle) a rectangle may have on the bf16
#: backward's fast path (``own::CAP``), and the taps an element of it may receive there
#: (``own::KMAX``); a rectangle with more takes its slower path.
OWNER_CAP, OWNER_KMAX = 512, 16
#: The bf16 forward's output tile, (width, height) (``stg::TW``, ``stg::TH`` in
#: ``csrc/backwarp.cu``), and the 16-byte chunks of a channel's footprint it stages
#: (``stg::CHUNKS``); a tile with more gathers directly.
STAGED_TILE, STAGED_CHUNKS = (32, 8), 256


def out_hw(h: int, w: int, stride: int) -> tuple[int, int]:
    return -(-h // stride), -(-w // stride)


def _corners(flow: torch.Tensor, stride: int, row0: int = 0):
    """Sample points ``x, y [B,h,w]`` (pixels, float32) and their floors ``x0, y0``; the output
    grid's rows start at the image's row ``row0`` (an integer, added before the flow)."""
    ho, wo = flow.shape[2], flow.shape[3]
    xs = torch.arange(wo, device=flow.device, dtype=torch.float32) * stride
    ys = (torch.arange(ho, device=flow.device, dtype=torch.int64) * stride + row0).float()
    x = xs[None, None, :] + flow[:, 0]
    y = ys[None, :, None] + flow[:, 1]
    return x, y, torch.floor(x), torch.floor(y)


def _taps(img: torch.Tensor, flow: torch.Tensor, stride: int, row0: int = 0):
    """The four bilinear taps of every output pixel: ``(dy, dx, wgt_y, wgt_x, ok, idx)``.

    ``idx [B,1,h*w]`` is the flat index of the corner (clamped into the map;
    ``ok`` says whether it is really inside), the weights are per pixel, in the map's dtype
    (the fractions taken in float32, then cast, as JAX ``gather_warp`` does).
    """
    b, _, h, w = img.shape
    ho, wo = flow.shape[2], flow.shape[3]
    x, y, x0, y0 = _corners(flow, stride, row0)
    wx = (x - x0).to(img.dtype)
    wy = (y - y0).to(img.dtype)
    taps = []
    for dy, wgt_y in ((0, 1.0 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1.0 - wx), (1, wx)):
            cx = x0 + dx
            cy = y0 + dy
            ok = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            # clamp before the integer conversion so huge coordinates stay defined, and send a
            # NaN one (a tap outside, as the kernels read it) to index 0
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).nan_to_num(0.0).long().reshape(b, 1, ho * wo)
            taps.append((dy, dx, wgt_y, wgt_x, ok, idx))
    return taps


def backwarp_plain(img: torch.Tensor, flow: torch.Tensor, stride: int = 1, row0: int = 0) -> torch.Tensor:
    """Plain PyTorch backwarp: a 4-tap bilinear gather with zeros outside the map, in ``img``'s dtype
    (``row0``: see the module docstring).

    The taps' products (of values and weights in the map's dtype) are summed in float32 and
    the sum rounded once, as JAX's ``einsum`` over the taps does in bf16.
    """
    b, c, h, w = img.shape
    ho, wo = flow.shape[2], flow.shape[3]
    flat = img.reshape(b, c, h * w)
    out = None
    for _, _, wgt_y, wgt_x, ok, idx in _taps(img, flow, stride, row0):
        vals = flat.gather(2, idx.expand(b, c, ho * wo)).reshape(b, c, ho, wo)
        tap = vals.float() * torch.where(ok, wgt_x * wgt_y, 0.0).float()[:, None]
        out = tap if out is None else out + tap
    return out.to(img.dtype)


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


def _tap_corners(flow: torch.Tensor, h: int, w: int, stride: int, row0: int = 0):
    """The four taps of every output pixel, ``(cx, cy, inside)`` of shape ``[4,B,ho,wo]``, as in
    :func:`_taps`."""
    _, _, x0, y0 = _corners(flow, stride, row0)
    cx = torch.stack([x0, x0 + 1, x0, x0 + 1])
    cy = torch.stack([y0, y0, y0 + 1, y0 + 1])
    return cx, cy, (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)


def _tile_footprints(flow: torch.Tensor, h: int, w: int, stride: int, tile=(TILE_W, TILE_H), row0: int = 0):
    """Per tile of ``tile`` (width, height) output pixels ``[B, nty, ntx]``: the bounding box
    ``(xmin, xmax, ymin, ymax)`` (float) of its pixels' taps inside the ``h x w`` map, and where
    it has none (``empty``; the box is then infinite)."""
    b, _, ho, wo = flow.shape
    tw, th = tile
    nty, ntx = -(-ho // th), -(-wo // tw)
    cx, cy, ok = _tap_corners(flow, h, w, stride, row0)

    def per_tile(v, fill, reduce):  # over the taps inside the map of each tile's pixels
        t = torch.full((4, b, nty * th, ntx * tw), fill, device=flow.device)
        t[:, :, :ho, :wo] = torch.where(ok, v, fill)
        return reduce(t.reshape(4, b, nty, th, ntx, tw), dim=(0, 3, 5))

    inf = float("inf")
    xmin, xmax = per_tile(cx, inf, torch.amin), per_tile(cx, -inf, torch.amax)
    ymin, ymax = per_tile(cy, inf, torch.amin), per_tile(cy, -inf, torch.amax)
    return xmin, xmax, ymin, ymax, torch.isinf(xmin)


def tile_windows(flow: torch.Tensor, h: int, w: int, stride: int) -> TileWindows:
    """The tile rule of ``csrc/backwarp_bwd.cu``'s float32 form: each tile's footprint and whether it fits.

    A tile is ``TILE_W x TILE_H`` output pixels; its footprint is the bounding box of
    the taps of its pixels that lie inside the ``h x w`` map. The kernel reduces a
    tile that fits ``WINDOW_VEC4`` in shared memory and scatters any other
    tile with global atomics; a tile with no tap inside fits.
    """
    xmin, xmax, ymin, ymax, empty = _tile_footprints(flow, h, w, stride)
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


def owner_grid(h: int, w: int) -> tuple[int, int]:
    """Rows and columns of the bf16 backward's owner rectangles on an ``h x w`` map."""
    return -(-h // OWNER_H), -(-w // OWNER_W)


class OwnerRects(NamedTuple):
    """Per owner rectangle ``[B, ceil(h/OWNER_H), ceil(w/OWNER_W)]`` of the bf16 backward (int64, bool)."""

    x0: torch.Tensor      # candidate box: output columns x0..x1, rows y0..y1 (inclusive)
    x1: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor
    empty: torch.Tensor     # no tile's footprint overlaps the rectangle (the box is meaningless)
    n_cand: torch.Tensor    # output pixels with a tap inside the map and inside the rectangle
    max_taps: torch.Tensor  # the most taps that land on one element of the rectangle
    slow: torch.Tensor      # the slower path: n_cand > OWNER_CAP or max_taps > OWNER_KMAX


def owner_rects(flow: torch.Tensor, h: int, w: int, stride: int) -> OwnerRects:
    """The owner rule of ``csrc/backwarp_bwd.cu``'s bf16 form: each rectangle's candidate box and path.

    The pre-pass takes tiles of ``TILE_W x TILE_H`` output pixels (those of
    :func:`tile_windows`); a tile whose footprint (the bounding box of its taps inside the map)
    overlaps a rectangle widens that rectangle's box by the tile's pixels. So every output pixel
    with a tap in a rectangle lies in its box. A rectangle with more than ``OWNER_CAP``
    candidates, or an element on which more than ``OWNER_KMAX`` taps land, takes the kernel's
    slower path.
    """
    b, _, ho, wo = flow.shape
    nry, nrx = owner_grid(h, w)
    dev = flow.device
    xmin, xmax, ymin, ymax, empty = _tile_footprints(flow, h, w, stride)
    nty, ntx = empty.shape[1:]
    keep = ~empty.reshape(-1)
    bi = torch.arange(b, device=dev)[:, None, None].expand(b, nty, ntx).reshape(-1)[keep]
    ty = torch.arange(nty, device=dev)[None, :, None].expand(b, nty, ntx).reshape(-1)[keep]
    tx = torch.arange(ntx, device=dev)[None, None, :].expand(b, nty, ntx).reshape(-1)[keep]
    rx0, rx1 = (v.reshape(-1)[keep].long() // OWNER_W for v in (xmin, xmax))
    ry0, ry1 = (v.reshape(-1)[keep].long() // OWNER_H for v in (ymin, ymax))
    nx, n = rx1 - rx0 + 1, (rx1 - rx0 + 1) * (ry1 - ry0 + 1)
    tile = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
    k = torch.arange(tile.numel(), device=dev) - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    rect = (bi[tile] * nry + ry0[tile] + k // nx[tile]) * nrx + rx0[tile] + k % nx[tile]
    big = 2**62
    boxes = []
    for v, sign in ((tx * TILE_W, 1), (torch.clamp(tx * TILE_W + TILE_W - 1, max=wo - 1), -1),
                    (ty * TILE_H, 1), (torch.clamp(ty * TILE_H + TILE_H - 1, max=ho - 1), -1)):
        init = torch.full((b * nry * nrx,), big, device=dev, dtype=torch.long)
        boxes.append(sign * init.scatter_reduce(0, rect, sign * v[tile], "amin").reshape(b, nry, nrx))
    # the candidates: each pixel counted once in each rectangle that one of its taps inside lands in
    cx, cy, ok = _tap_corners(flow, h, w, stride)
    ids = torch.where(ok, ((torch.arange(b, device=dev)[:, None, None] * nry + cy.clamp(0, h - 1).long() // OWNER_H)
                           * nrx + cx.clamp(0, w - 1).long() // OWNER_W), -1)
    first = torch.ones_like(ok)
    for kk in range(1, 4):
        first[kk] = (ids[kk] != ids[:kk]).all(0)
    ids = ids[(ids >= 0) & first]
    n_cand = torch.bincount(ids, minlength=b * nry * nrx).reshape(b, nry, nrx)
    # the taps on each element of the map, padded to whole rectangles
    pix = (torch.arange(b, device=dev)[:, None, None] * h + cy.clamp(0, h - 1).long()) * w + cx.clamp(0, w - 1).long()
    taps = torch.zeros((b, nry * OWNER_H, nrx * OWNER_W), device=dev, dtype=torch.long)
    taps[:, :h, :w] = torch.bincount(pix[ok], minlength=b * h * w).reshape(b, h, w)
    max_taps = taps.reshape(b, nry, OWNER_H, nrx, OWNER_W).amax(dim=(2, 4))
    return OwnerRects(*boxes, boxes[0] == big, n_cand, max_taps,
                      (n_cand > OWNER_CAP) | (max_taps > OWNER_KMAX))


def slow_rectangles(flow: torch.Tensor, h: int, w: int, stride: int) -> int:
    """How many rectangles :func:`owner_rects` sends down the bf16 backward's slower path."""
    return int(owner_rects(flow, h, w, stride).slow.sum())


def slow_rect_counter(device: torch.device) -> torch.Tensor:
    """The bf16 backward kernel's running count (int32, on ``device``) of owner rectangles that
    took its slower path; a caller zeroes it to count over a stretch of launches."""
    return kernels.device_counter("backwarp_bwd_bf16 slow rectangles", device)


def staged_tiles(flow: torch.Tensor, h: int, w: int, stride: int, aligned: bool = True,
                 row0: int = 0) -> torch.Tensor:
    """The tile rule of ``csrc/backwarp.cu``'s bf16 form: per tile ``[B, ceil(ho/8), ceil(wo/32)]``
    of output pixels, whether it gathers directly (bool).

    A tile's footprint is the bounding box of its pixels' taps inside the ``h x w`` map, from
    x rounded down to a multiple of 8; it is staged in 16-byte chunks of 8 values a row. A tile
    whose footprint has more than ``STAGED_CHUNKS`` chunks, or every tile where the map's rows
    are not 16-byte aligned (``w % 8``, or ``aligned`` False: the tensor is off 16 bytes),
    gathers directly; a tile with no tap inside stages nothing.
    """
    xmin, xmax, ymin, ymax, empty = _tile_footprints(flow, h, w, stride, STAGED_TILE, row0)
    x0 = torch.where(empty, 0.0, torch.floor(xmin / 8) * 8)
    chunks = torch.where(empty, 0.0, (torch.div(xmax - x0, 8, rounding_mode="floor") + 1) * (ymax - ymin + 1))
    if w % 8 or not aligned:
        return torch.ones_like(empty)
    return chunks > STAGED_CHUNKS


def direct_tile_counter(device: torch.device) -> torch.Tensor:
    """The bf16 forward kernel's running count (int32, on ``device``) of tiles that gathered
    directly; a caller zeroes it to count over a stretch of launches."""
    return kernels.device_counter("backwarp_bf16 direct tiles", device)


def _forward(img: torch.Tensor, flow: torch.Tensor, stride: int, row0: int = 0) -> torch.Tensor:
    """The kernel's output for CUDA operands, counted in :data:`launches` or :data:`bf16_launches`."""
    global launches, bf16_launches
    b, c = img.shape[:2]
    out = torch.empty((b, c, *flow.shape[2:]), device=img.device, dtype=img.dtype)
    if out.numel():
        # row0 is passed only where it is not 0: the unsharded calls keep _launch's four arguments
        _launch(img, flow, stride, out, *((row0,) if row0 else ()))
        if img.dtype == torch.bfloat16:
            bf16_launches += 1
        else:
            launches += 1
    return out


class _Backwarp(torch.autograd.Function):
    """The kernel path: ``csrc/backwarp.cu`` forward, ``csrc/backwarp_bwd.cu`` backward."""

    @staticmethod
    def forward(ctx, img, flow, stride):
        ctx.stride = stride
        ctx.save_for_backward(img, flow)
        return _forward(img, flow, stride)

    @staticmethod
    def backward(ctx, gout):
        global bwd_launches, bwd_bf16_launches
        img, flow = ctx.saved_tensors
        gout = gout.contiguous()
        g_img = torch.empty_like(img)
        g_flow = torch.empty_like(flow)
        kernels.on_cuda("backwarp_bwd", img, flow, gout, g_img, g_flow)
        if gout.numel():  # empty only when img is empty too
            _launch_bwd(img, flow, gout, ctx.stride, g_img, g_flow)
            if img.dtype == torch.bfloat16:
                bwd_bf16_launches += 1
            else:
                bwd_launches += 1
        return g_img, g_flow, None


def backwarp(img: torch.Tensor, flow: torch.Tensor, stride: int = 1, row0: int = 0) -> torch.Tensor:
    """Backwarp ``img`` by ``flow`` on the stride-``stride`` grid; kernel on CUDA, plain version on the CPU.

    Both float32 or both bfloat16; the result has their dtype. ``flow [B,2,h,ceil(W/s)]``: the
    whole grid (``h = ceil(H/s)``, ``row0 = 0``), or a slab's rows, starting at the image's row
    ``row0`` (the module docstring). Differentiable in ``img`` and ``flow`` on both paths, in
    their dtype, where ``row0`` is 0; the backward kernel has no row offset, so on CUDA a call
    with ``row0`` raises where a gradient is wanted.
    """
    if img.dim() != 4 or flow.dim() != 4:
        raise ValueError("backwarp: img and flow must be [B,C,H,W] and [B,2,h,w]")
    b, c, h, w = img.shape
    wo = out_hw(h, w, stride)[1]
    if (stride not in (1, 2) or tuple(flow.shape[:2]) != (b, 2) or flow.shape[3] != wo
            or int(row0) != row0 or row0 < 0):
        raise ValueError(f"backwarp: flow {tuple(flow.shape)} does not fit img "
                         f"{tuple(img.shape)} at stride {stride} (stride 1 or 2) and row {row0}")
    if not kernels.on_cuda("backwarp", img, flow):
        return backwarp_plain(img, flow, stride, int(row0))
    if not row0:
        return _Backwarp.apply(img, flow, stride)
    if torch.is_grad_enabled() and (img.requires_grad or flow.requires_grad):
        raise NotImplementedError("backwarp: a slab with row0 > 0 is forward only on CUDA "
                                  "(the backward kernel takes no row offset)")
    return _forward(img, flow, stride, int(row0))


def _launch(img: torch.Tensor, flow: torch.Tensor, stride: int, out: torch.Tensor, row0: int = 0) -> None:
    """The kernel call itself (a test can substitute a fake); the bf16 form also adds its tiles
    that gathered directly to :func:`direct_tile_counter`."""
    b, c, h, w = img.shape
    counter = (direct_tile_counter(img.device).data_ptr(),) if img.dtype == torch.bfloat16 else ()
    kernels.launch(kernels.entry("backwarp", img.dtype), "backwarp", img.device,
                   img.data_ptr(), flow.data_ptr(), out.data_ptr(), *counter,
                   b, c, h, w, out.shape[2], out.shape[3], stride, row0)


def _launch_bwd(img: torch.Tensor, flow: torch.Tensor, gout: torch.Tensor, stride: int,
                g_img: torch.Tensor, g_flow: torch.Tensor) -> None:
    """The backward kernel call itself (a test can substitute a fake); it overwrites both
    outputs. The float32 form adds its out-of-window tiles to :func:`out_of_window_counter`;
    the bf16 form adds its slow-path rectangles to :func:`slow_rect_counter` and takes the
    int32 boxes of its owner rectangles (4 each), allocated here for the launch."""
    b, c, h, w = img.shape
    if img.dtype == torch.bfloat16:
        # held until the launch is queued; the caching allocator orders its reuse after the kernel
        boxes = torch.empty((b, *owner_grid(h, w), 4), device=img.device, dtype=torch.int32)
        counters = (slow_rect_counter(img.device).data_ptr(), boxes.data_ptr())
    else:
        counters = (out_of_window_counter(img.device).data_ptr(),)
    kernels.launch(kernels.entry("backwarp_bwd", img.dtype), "backwarp_bwd", img.device,
                   img.data_ptr(), flow.data_ptr(), gout.data_ptr(), g_img.data_ptr(),
                   g_flow.data_ptr(), *counters, b, c, h, w, gout.shape[2], gout.shape[3], stride)
