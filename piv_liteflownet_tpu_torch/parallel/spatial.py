"""Spatial (H-axis) sharding of the eval forward, for frames larger than one card.

Port of ``piv_liteflownet_tpu/parallel/spatial.py``. The reference centre-crops
or resizes large frames to fit one GPU; JAX shards the frame's height over a
mesh and lets GSPMD insert the halo exchanges. Here each rank of a ``spatial``
mesh (``parallel/mesh.py``) runs the model's eval forward on its rows of both
frames, ``H / N`` each, under the context of ``parallel/ctx.py``, and the
forward asks for its neighbours' rows wherever an op reads across rows:

- :func:`on_slab`: an op or a stack of convs runs on the rank's rows extended by
  the rows its receptive field needs, one exchange for all of it, and its
  result is cropped back to the rank's rows. At the frame's top and bottom it
  adds no rows, so each conv's zero padding falls on the true edge, as in the
  unsharded forward. NetC's stages, the two deconvs, the cost volume with the
  NetE-M stack after it, the NetE-S stack and NetE-R's tail (its stack, the
  dist convs and the unfold) take it.
- the warps: ``ops/halo_warp.py`` (K4 on slabs). NetE-R's occlusion norm warps
  there too, and takes the norm after it, as JAX does under its context: the
  fused kernel K3 takes equal shapes only.
- :func:`mean_hw`: NetE-R's flow mean, an all-reduce of the ranks' sums.

The pyramid's bilinear halving reads rows 2i and 2i+1 only, and every shard
starts on an even row, so it stays local. Shards are equal and a multiple of 32
rows (:func:`spatial_estimate` asks H to be a multiple of 32 N), so each
level's shard is whole and the stride-2 ops start on even rows.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from piv_liteflownet_tpu_torch.ops.halo_warp import extend_rows, gather_backwarp, halo_backwarp, v_bound_ok
from piv_liteflownet_tpu_torch.parallel.ctx import SpatialCtx, spatial_context
from piv_liteflownet_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce


def on_slab(ctx: SpatialCtx, fn: Callable, xs: Sequence[torch.Tensor], halo: int, down: int = 1,
            up: int = 1, label: str = "") -> torch.Tensor:
    """``fn(*xs)`` on this rank's rows of the H-sharded maps ``xs`` (equal row counts), each
    extended by ``halo`` rows on both sides, cropped back to this rank's rows of the result.

    ``fn`` maps ``r`` input rows to ``r * up / down`` output rows, its output row ``j`` at the
    input's row ``j * down / up`` (a stride-``down`` conv, a stride-``up`` deconv); ``halo`` is a
    multiple of ``down``, so the slab starts on the stride's grid.
    """
    hs = xs[0].shape[2]
    if halo % down or hs % down:
        raise ValueError(f"on_slab: halo {halo} and shard of {hs} rows must be multiples of {down}")
    slabs = []
    for x in xs:
        slab, added = extend_rows(x, ctx.mesh, halo, halo, label)
        slabs.append(slab)
    start = added * up // down
    return fn(*slabs)[:, :, start:start + hs * up // down].contiguous()


def mean_hw(ctx: SpatialCtx, x: torch.Tensor) -> torch.Tensor:
    """The mean over H and W of the H-sharded ``x [B,C,Hs,W]`` (float32 sums), in ``x``'s dtype."""
    total = x.float().sum(dim=(2, 3), keepdim=True)
    all_reduce(ctx.mesh, total)
    return (total / (x.shape[2] * ctx.mesh.size * x.shape[3])).to(x.dtype)


def spatial_estimate(model, img1: torch.Tensor, img2: torch.Tensor, mesh: Mesh, halo: int = 32,
                     halo_warp: bool = True, ops=None) -> torch.Tensor:
    """The eval forward of ``img1, img2 [B,3,H,W]`` with H sharded over ``mesh``.

    Every rank passes the whole frames (on its device, in the model's dtype), with H a
    multiple of ``32 * mesh.size``; each runs its ``H / N`` rows. Returns the forward's flow
    ``[B,2,H',W']``, gathered on every rank (the one gather of whole maps, besides those of the
    warps that fall back). ``halo``: the rows a warp exchanges (exact while ``|v| < halo``,
    checked); ``halo_warp=False``: every warp gathers the whole map. ``ops``: the kernels
    (default) or their plain versions.
    """
    from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS

    n, h = mesh.size, img1.shape[2]
    if h % (32 * n):
        raise ValueError(f"spatial_estimate: H = {h} is not a multiple of 32 x {n} ranks")
    rows = slice(mesh.rank * h // n, (mesh.rank + 1) * h // n)
    x1, x2 = img1[:, :, rows].contiguous(), img2[:, :, rows].contiguous()
    with spatial_context(mesh, mesh.axis, halo, halo_warp):
        flow = model(x1, x2, ops or KERNEL_OPS)
    out = all_gather(mesh, flow, 2)
    mesh.traffic.gathers.append(("output", (out.numel() - flow.numel()) * flow.element_size()))
    return out


def spatial_backwarp(ctx: SpatialCtx, img: torch.Tensor, flow: torch.Tensor, stride: int,
                     backwarp: Callable) -> torch.Tensor:
    """The model's warp under the context, by JAX's rule (``models/liteflownet.py:306-319``): the
    halo warp where a shard holds at least ``halo`` rows and every ``|v| < halo`` on every rank,
    else this rank's rows warped against the whole map (``ops/halo_warp.py``)."""
    mesh = ctx.mesh
    if ctx.halo_warp and mesh.size > 1 and img.shape[2] >= ctx.halo:
        if v_bound_ok(flow, ctx.halo, mesh):
            return halo_backwarp(img, flow, mesh, ctx.halo, stride, backwarp)
        return gather_backwarp(img, flow, mesh, stride, backwarp, "warp fallback")
    return gather_backwarp(img, flow, mesh, stride, backwarp, "warp gather")
