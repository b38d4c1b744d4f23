"""The halo-exchange backwarp of H-sharded maps, and the row exchange it rests on.

Port of ``piv_liteflownet_tpu/ops/halo_warp.py``. Under spatial sharding
(``parallel/spatial.py``) each rank holds ``Hs = H / N`` rows of every map, rank r
rows ``[r*Hs, (r+1)*Hs)``. A warp's output row may read any input row, so a
shard alone cannot warp; but a PIV flow moves few pixels:

1. :func:`extend_rows` brings ``halo`` boundary rows from the neighbours
   (point-to-point sends, ``parallel/mesh.py:exchange``), zeros past the
   frame's top and bottom (the zeros the unsharded warp reads outside the map);
2. the port's ``backwarp`` (K4 on the card: ``csrc/backwarp.cu``, float32 and
   bf16; its plain version on the CPU) runs on the ``[B,C,Hs+2*halo,W]`` slab,
   its output rows starting at the slab's row ``halo`` (the kernel's ``row0``:
   an integer offset, so that the flow is not rebased in its own dtype).

This is exact while every ``|v| < halo``: :func:`v_bound_ok` takes the maximum
over all ranks, so that every rank takes the same branch (a rank falling back
alone would leave the others waiting in their exchange). Otherwise
:func:`gather_backwarp` gathers the whole map and warps this rank's output rows
against it, still through K4, with the rows starting at ``r*Hs``: JAX's
``lax.cond`` fallback (``models/liteflownet.py:314-319``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from piv_liteflownet_tpu_torch.ops import warp
from piv_liteflownet_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, exchange


def extend_rows(x: torch.Tensor, mesh: Mesh, top: int, bottom: int, label: str = "",
                zeros: bool = False) -> tuple[torch.Tensor, int]:
    """This rank's rows ``x [B,C,Hs,W]`` of an H-sharded map, with ``top`` rows above and
    ``bottom`` below from the ranks that hold them (any number of ranks away).

    Past the frame's top and bottom it adds no rows, or with ``zeros`` zero rows, so that the
    slab is always ``Hs + top + bottom`` rows. Returns the slab and the rows above this rank's
    first that it holds. Records the call in ``mesh.traffic.halo``.
    """
    n, r = mesh.size, mesh.rank
    b, c, hs, w = x.shape
    h = n * hs
    lo, hi = max(0, r * hs - top), min(h, (r + 1) * hs + bottom)
    sends, recvs, above, below = [], [], [], []
    for q in range(n):
        if q == r:
            continue
        a, e = max(lo, q * hs), min(hi, (q + 1) * hs)  # rows of q's that this rank takes
        if a < e:
            buf = torch.empty((b, c, e - a, w), device=x.device, dtype=x.dtype)
            recvs.append((q, buf))
            (above if q < r else below).append(buf)
        qlo, qhi = max(0, q * hs - top), min(h, (q + 1) * hs + bottom)
        a, e = max(qlo, r * hs), min(qhi, (r + 1) * hs)  # rows of this rank's that q takes
        if a < e:
            sends.append((q, x[:, :, a - r * hs:e - r * hs]))
    exchange(mesh, sends, recvs)
    row_bytes = b * c * w * x.element_size()
    mesh.traffic.halo.append((label, r * hs - lo, hi - (r + 1) * hs, row_bytes,
                              sum(t.numel() for _, t in sends) * x.element_size(),
                              sum(t.numel() for _, t in recvs) * x.element_size()))
    parts, added = above + [x] + below, r * hs - lo
    if zeros:
        if top > added:
            parts.insert(0, x.new_zeros((b, c, top - added, w)))
        if bottom > hi - (r + 1) * hs:
            parts.append(x.new_zeros((b, c, bottom - (hi - (r + 1) * hs), w)))
        added = top
    return (torch.cat(parts, 2) if len(parts) > 1 else x), added


def v_bound_ok(flow: torch.Tensor, halo: int, mesh: Optional[Mesh] = None) -> bool:
    """Whether the halo warp is exact for ``flow [B,2,h,w]``: ``max |v| < halo``, the maximum over
    every rank of ``mesh`` (a NaN counts as out of bound). Every rank must call it."""
    v = flow[:, 1].float().abs()
    m = (v.amax() if v.numel() else v.new_zeros(())).reshape(1)
    m = torch.nan_to_num(m, nan=float("inf"))
    if mesh is not None:
        all_reduce(mesh, m, "max")
    return bool(m.item() < float(halo))


def halo_backwarp(img: torch.Tensor, flow: torch.Tensor, mesh: Mesh, halo: int = 32, stride: int = 1,
                  backwarp: Callable = warp.backwarp) -> torch.Tensor:
    """The H-sharded backwarp through ``halo`` exchanged rows (the module docstring).

    ``img [B,C,Hs,W]``: this rank's rows; ``flow [B,2,Hs/stride,ceil(W/stride)]``: this rank's
    rows of the stride-``stride`` output grid. Exact while every ``|v| < halo``; the caller
    checks :func:`v_bound_ok`. ``backwarp``: the warp that runs on the slab (the kernel
    wrapper, or a plain version), taking ``(img, flow, stride, row0)``.
    """
    if img.shape[2] % stride:
        raise ValueError(f"halo_backwarp: a shard of {img.shape[2]} rows at stride {stride}")
    slab, _ = extend_rows(img, mesh, halo, halo, "halo warp", zeros=True)
    return backwarp(slab, flow, stride, halo)


def gather_backwarp(img: torch.Tensor, flow: torch.Tensor, mesh: Mesh, stride: int = 1,
                    backwarp: Callable = warp.backwarp, label: str = "warp fallback") -> torch.Tensor:
    """This rank's output rows warped against the whole map, gathered from every rank."""
    full = all_gather(mesh, img, 2)
    mesh.traffic.gathers.append((label, (full.numel() - img.numel()) * img.element_size()))
    return backwarp(full, flow, stride, mesh.rank * img.shape[2])
