"""The 7x7 cost volume (49 displacements) on phase-subsampled maps.

Port of ``piv_liteflownet_tpu/ops/correlation.py:correlation_xla`` applied to
maps the caller has already subsampled, which is also what the TPU kernels
``ops/pallas_corr.py:correlation_pallas`` and ``:correlation_planar_pallas``
compute. NCHW here: ``[B,C,H,W] x 2 -> [B,49,H,W]``.

``corr49`` launches the CUDA kernel ``csrc/corr49.cu`` for CUDA tensors and
takes :func:`corr49_plain` for CPU tensors, which autograd differentiates.
On CUDA the op is a ``torch.autograd.Function`` whose backward launches
``csrc/corr49_bwd.cu``: both input gradients as gathers, in one launch.
:func:`corr49_bwd_plain` is its plain version. The TPU package has no
kernel for this backward (JAX takes the XLA VJP of the shift-stack).

Both kernels tile the output as ``csrc/corr_tiles.cuh`` describes: a block
stages a map's tile plus its 3-pixel halo, channel group by channel group,
and each thread sums 4 adjacent pixels for one displacement row in
registers. :func:`tile_plan` is their tile rule. A launch whose rows are not
16-byte aligned (width not a multiple of 4, or a misaligned tensor) takes
the kernels' edge path and adds its tiles to :func:`edge_tile_counter`.

The forward has a bfloat16 form (``pivk_corr49_bf16``): the same function
on bf16 maps, summed in float32 and rounded once to bf16. A 16-byte row chunk
holds 8 bf16, so its vector path needs a width that is a multiple of 8.
:func:`corr49_plain` keeps its operands' dtype. bf16 has no backward kernel
yet: its backward raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from piv_liteflownet_tpu_torch import kernels

MD = 3
NDISP = (2 * MD + 1) ** 2

#: Kernel launches made by :func:`corr49` (plain-path calls do not count): the float32 form.
launches = 0
#: Launches of the forward kernel's bfloat16 form.
bf16_launches = 0
#: Launches of the backward kernel, made by the backward of :func:`corr49` on CUDA.
bwd_launches = 0

#: Output tile (width, height) of a block of ``csrc/corr49.cu`` and of ``csrc/corr49_bwd.cu``
#: (whose blocks each take one of the two outputs of a tile).
FWD_TILE = (32, 8)
BWD_TILE = (32, 8)
#: Channels per stage and stages in the ring of both kernels (``CC``, ``NS``).
STAGE_CHANNELS, STAGES = 8, 3
#: Shared memory a block may take on an H100 (227 KB).
SMEM_LIMIT = 232448


class CorrTiles(NamedTuple):
    """The tiles of one launch of a cost-volume kernel."""

    x0: list[int]        # column origin of each tile column
    y0: list[int]        # row origin of each tile row
    tile: tuple[int, int]  # (width, height) of a tile
    batch: int           # the grid's third axis: the batch, times 2 outputs for the backward
    smem: int            # dynamic shared memory of a block, bytes
    edge: bool           # 4-byte staging: the width is not a multiple of 4 (or a tensor is misaligned)

    @property
    def n_tiles(self) -> int:
        return len(self.x0) * len(self.y0) * self.batch


def chunk_values(dtype: torch.dtype = torch.float32) -> int:
    """Values in one 16-byte row chunk: 4 float32, 8 bfloat16."""
    return 16 // dtype.itemsize


def smem_bytes(backward: bool, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of a block, as ``SMEM`` in the kernel's source works it out.

    Forward: a ring of ``STAGES`` stages, each ``STAGE_CHANNELS`` f2 tiles plus halo
    ((TY+6) x (TX+2*pad), pad 4 in float32 and 8 in bf16, a whole chunk) and f1 tiles
    (TY x TX), in ``dtype``. Backward (float32 only): a ring of stages, each
    ``STAGE_CHANNELS`` tiles plus halo of one map in rows of TX+12 floats, the last stage
    sharing its memory with g's mirrored windows (per displacement, TY rows of TX+4 floats,
    + 4).
    """
    tx, ty = BWD_TILE if backward else FWD_TILE
    sh = ty + 2 * MD
    if not backward:
        pad = max(chunk_values(dtype), MD + 1)
        return dtype.itemsize * STAGES * STAGE_CHANNELS * (sh * (tx + 2 * pad) + ty * tx)
    if dtype != torch.float32:
        raise ValueError(f"the cost-volume backward kernel has no {dtype} form")
    stage = STAGE_CHANNELS * sh * (tx + 12)
    return 4 * ((STAGES - 1) * stage + max(stage, NDISP * (ty * (tx + 4) + 4)))


def tile_plan(b: int, h: int, w: int, backward: bool = False, aligned: bool = True,
              dtype: torch.dtype = torch.float32) -> CorrTiles:
    """The tile rule of ``csrc/corr49.cu`` (or, with ``backward``, ``csrc/corr49_bwd.cu``) on
    maps of ``dtype``.

    ``aligned``: whether every tensor of the launch starts 16 bytes aligned, as
    :func:`uses_edge_path` checks.
    """
    tx, ty = BWD_TILE if backward else FWD_TILE
    return CorrTiles(list(range(0, w, tx)), list(range(0, h, ty)), (tx, ty), 2 * b if backward else b,
                     smem_bytes(backward, dtype), w % chunk_values(dtype) != 0 or not aligned)


def uses_edge_path(*tensors: torch.Tensor) -> bool:
    """Whether a launch on these tensors (the kernel's inputs and, forward, output) takes the edge path:
    rows not a whole number of 16-byte chunks, or a tensor not 16 bytes aligned."""
    return (tensors[0].shape[-1] % chunk_values(tensors[0].dtype) != 0
            or any(t.data_ptr() % 16 for t in tensors))


def edge_tile_counter(device: torch.device) -> torch.Tensor:
    """Both kernels' running count (int32, on ``device``) of tiles that took the edge path;
    a caller zeroes it to count over a stretch of launches."""
    return kernels.device_counter("corr49 edge tiles", device)


def corr49_plain(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """``out[b, (dy+3)*7+dx+3, y, x] = (1/C) sum_c f1[b,c,y,x] f2[b,c,y+dy,x+dx]``, zeros outside,
    in the maps' dtype."""
    b, c, h, w = f1.shape
    f2p = F.pad(f2, (MD, MD, MD, MD))
    out = f1.new_empty((b, NDISP, h, w))
    for dy in range(2 * MD + 1):
        for dx in range(2 * MD + 1):
            out[:, dy * (2 * MD + 1) + dx] = (
                (f1 * f2p[:, :, dy:dy + h, dx:dx + w]).sum(1) * (1.0 / c))
    return out


def corr49_bwd_plain(f1: torch.Tensor, f2: torch.Tensor,
                     g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(g_f1, g_f2)`` of :func:`corr49_plain` for the output gradient ``g [B,49,H,W]``.

    ``g_f1[c,y,x] = (1/C) sum_d g[d,y,x] f2[c,y+dy,x+dx]`` and
    ``g_f2[c,y,x] = (1/C) sum_d g[d,y-dy,x-dx] f1[c,y-dy,x-dx]``, zeros outside.
    """
    b, c, h, w = f1.shape
    f2p = F.pad(f2, (MD, MD, MD, MD))
    g_f1 = torch.zeros_like(f1)
    g_f2p = torch.zeros_like(f2p)
    for dy in range(2 * MD + 1):
        for dx in range(2 * MD + 1):
            gd = g[:, dy * (2 * MD + 1) + dx, None] * (1.0 / c)
            g_f1 += gd * f2p[:, :, dy:dy + h, dx:dx + w]
            g_f2p[:, :, dy:dy + h, dx:dx + w] += gd * f1
    return g_f1, g_f2p[:, :, MD:MD + h, MD:MD + w].contiguous()


class _Corr49(torch.autograd.Function):
    """The kernel path: ``csrc/corr49.cu`` forward, ``csrc/corr49_bwd.cu`` backward."""

    @staticmethod
    def forward(ctx, f1, f2):
        global launches, bf16_launches
        b, c, h, w = f1.shape
        out = torch.empty((b, NDISP, h, w), device=f1.device, dtype=f1.dtype)
        ctx.save_for_backward(f1, f2)
        if out.numel():
            _launch(f1, f2, out)
            if f1.dtype == torch.bfloat16:
                bf16_launches += 1
            else:
                launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        f1, f2 = ctx.saved_tensors
        if f1.dtype == torch.bfloat16:
            raise NotImplementedError(
                "corr49 has no bfloat16 backward kernel yet: bf16 training comes with the "
                "bf16 backward kernels (ROADMAP.md, Queue 2 item 1)")
        g = g.contiguous()
        g_f1 = torch.empty_like(f1)
        g_f2 = torch.empty_like(f2)
        kernels.on_cuda("corr49_bwd", f1, f2, g, g_f1, g_f2)
        if g_f1.numel():
            _launch_bwd(f1, f2, g, g_f1, g_f2)
            bwd_launches += 1
        return g_f1, g_f2


def corr49(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Cost volume of two ``[B,C,H,W]`` maps, both float32 or both bfloat16, in their dtype; kernel
    on CUDA, plain version on the CPU.

    Differentiable in both maps on both paths in float32; on CUDA a bfloat16 backward raises.
    """
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"corr49: expected two equal [B,C,H,W] maps, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if not kernels.on_cuda("corr49", f1, f2):
        return corr49_plain(f1, f2)
    return _Corr49.apply(f1, f2)


def _launch(f1: torch.Tensor, f2: torch.Tensor, out: torch.Tensor) -> None:
    """The kernel call itself (a test can substitute a fake); an edge-path launch adds its
    tiles to :func:`edge_tile_counter`."""
    b, c, h, w = f1.shape
    kernels.launch(kernels.entry("corr49", f1.dtype), "corr49", f1.device,
                   f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
                   edge_tile_counter(f1.device).data_ptr(), b, c, h, w)


def _launch_bwd(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                g_f1: torch.Tensor, g_f2: torch.Tensor) -> None:
    """The backward kernel call itself (a test can substitute a fake); it overwrites both
    outputs, and an edge-path launch adds its tiles to :func:`edge_tile_counter`."""
    b, c, h, w = f1.shape
    kernels.launch("pivk_corr49_bwd_f32", "corr49_bwd", f1.device,
                   f1.data_ptr(), f2.data_ptr(), g.data_ptr(), g_f1.data_ptr(),
                   g_f2.data_ptr(), edge_tile_counter(f1.device).data_ptr(), b, c, h, w)
