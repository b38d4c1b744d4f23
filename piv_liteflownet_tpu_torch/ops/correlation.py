"""The 7x7 cost volume (49 displacements) on phase-subsampled maps.

Port of ``piv_liteflownet_tpu/ops/correlation.py:correlation_xla`` applied to
maps the caller has already subsampled, which is also what the TPU kernels
``ops/pallas_corr.py:correlation_pallas`` and ``:correlation_planar_pallas``
compute. NCHW here: ``[B,C,H,W] x 2 -> [B,49,H,W]``.

``corr49`` launches the CUDA kernel ``csrc/corr49.cu`` for CUDA tensors (see
the note there: bound by bytes, f2 tile + halo staged in shared memory) and
takes :func:`corr49_plain` for CPU tensors, which autograd differentiates.
On CUDA the op is a ``torch.autograd.Function`` whose backward launches
``csrc/corr49_bwd.cu``: both input gradients as gathers, in one launch.
:func:`corr49_bwd_plain` is its plain version. The TPU package has no
kernel for this backward (JAX takes the XLA VJP of the shift-stack).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from piv_liteflownet_tpu_torch import kernels

MD = 3
NDISP = (2 * MD + 1) ** 2

#: Kernel launches made by :func:`corr49` (plain-path calls do not count).
launches = 0
#: Launches of the backward kernel, made by the backward of :func:`corr49` on CUDA.
bwd_launches = 0


def corr49_plain(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """``out[b, (dy+3)*7+dx+3, y, x] = (1/C) sum_c f1[b,c,y,x] f2[b,c,y+dy,x+dx]``, zeros outside."""
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
        global launches
        b, c, h, w = f1.shape
        out = torch.empty((b, NDISP, h, w), device=f1.device, dtype=f1.dtype)
        ctx.save_for_backward(f1, f2)
        if out.numel():
            _launch(f1, f2, out)
            launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        f1, f2 = ctx.saved_tensors
        g = g.contiguous()
        g_f1 = torch.empty_like(f1)
        g_f2 = torch.empty_like(f2)
        kernels.on_cuda("corr49_bwd", f1, f2, g, g_f1, g_f2)
        if g_f1.numel():
            _launch_bwd(f1, f2, g, g_f1, g_f2)
            bwd_launches += 1
        return g_f1, g_f2


def corr49(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Cost volume of two ``[B,C,H,W]`` float32 maps; kernel on CUDA, plain version on the CPU.

    Differentiable in both maps on both paths.
    """
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"corr49: expected two equal [B,C,H,W] maps, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if not kernels.on_cuda("corr49", f1, f2):
        return corr49_plain(f1, f2)
    return _Corr49.apply(f1, f2)


def _launch(f1: torch.Tensor, f2: torch.Tensor, out: torch.Tensor) -> None:
    """The kernel call itself (a test can substitute a fake)."""
    b, c, h, w = f1.shape
    kernels.launch("pivk_corr49_f32", "corr49", f1.device,
                   f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w)


def _launch_bwd(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                g_f1: torch.Tensor, g_f2: torch.Tensor) -> None:
    """The backward kernel call itself (a test can substitute a fake); it overwrites both outputs."""
    b, c, h, w = f1.shape
    kernels.launch("pivk_corr49_bwd_f32", "corr49_bwd", f1.device,
                   f1.data_ptr(), f2.data_ptr(), g.data_ptr(), g_f1.data_ptr(),
                   g_f2.data_ptr(), b, c, h, w)
