"""The 7x7 cost volume (49 displacements) on phase-subsampled maps.

Port of ``piv_liteflownet_tpu/ops/correlation.py:correlation_xla`` applied to
maps the caller has already subsampled, which is also what the TPU kernels
``ops/pallas_corr.py:correlation_pallas`` and ``:correlation_planar_pallas``
compute. NCHW here: ``[B,C,H,W] x 2 -> [B,49,H,W]``.

``corr49`` launches the CUDA kernel ``csrc/corr49.cu`` for CUDA tensors (see
the note there: bound by bytes, f2 tile + halo staged in shared memory) and
takes :func:`corr49_plain` for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from piv_liteflownet_tpu_torch import kernels

MD = 3
NDISP = (2 * MD + 1) ** 2

#: Kernel launches made by :func:`corr49` (plain-path calls do not count).
launches = 0


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


def corr49(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Cost volume of two ``[B,C,H,W]`` float32 maps; kernel on CUDA, plain version on the CPU."""
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"corr49: expected two equal [B,C,H,W] maps, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if not kernels.on_cuda("corr49", f1, f2):
        return corr49_plain(f1, f2)
    global launches
    b, c, h, w = f1.shape
    out = torch.empty((b, NDISP, h, w), device=f1.device, dtype=f1.dtype)
    if out.numel() == 0:
        return out
    _launch(f1, f2, out)
    launches += 1
    return out


def _launch(f1: torch.Tensor, f2: torch.Tensor, out: torch.Tensor) -> None:
    """The kernel call itself (a test can substitute a fake)."""
    b, c, h, w = f1.shape
    kernels.launch("pivk_corr49_f32", "corr49", f1.device,
                   f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w)
