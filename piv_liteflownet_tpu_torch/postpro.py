"""Flow post-processing: vorticity and strains from Sobel derivatives.

Port of ``piv_liteflownet_tpu/postpro.py``. Flows are ``[H,W,2]`` or
``[B,H,W,2]`` tensors (u, v); the results keep the flow's device and float
dtype. The derivatives are 3x3 Sobel stencils over the field padded by one
edge pixel, divided by ``calib``, computed by shifted slices (exact
elementwise arithmetic: no TF32, on any device).

JAX pads ``calc_vorticity`` numpy-``"symmetric"`` and ``de_vort`` ``"edge"``:
for a pad of 1 both are torch's ``"replicate"``. ``calc_vorticity`` flips its
kernels to match ``scipy.signal.convolve2d``, ``de_vort`` correlates with its
own unflipped ones, and with these kernels the two give the same stencils:
``du`` (du/dy) correlates u with ``DY`` and ``dv`` (dv/dx) correlates v with
``DX``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

#: dv/dx: the flipped ``[[1,0,-1],[2,0,-2],[1,0,-1]] / 8`` of ``calc_vorticity``, ``de_vort``'s ``kx``.
DX = ((-0.125, 0.0, 0.125), (-0.25, 0.0, 0.25), (-0.125, 0.0, 0.125))
#: du/dy: the flipped ``-([[1,0,-1],[2,0,-2],[1,0,-1]] / 8).T`` of ``calc_vorticity``, ``de_vort``'s ``ky``.
DY = ((0.125, 0.25, 0.125), (0.0, 0.0, 0.0), (-0.125, -0.25, -0.125))


def _correlate3(x: torch.Tensor, k) -> torch.Tensor:
    """3x3 correlation of ``x [B,H,W]`` with ``k`` over ``x`` edge-padded by one pixel."""
    h, w = x.shape[-2:]
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    out = None
    for i in range(3):
        for j in range(3):
            if k[i][j]:
                term = k[i][j] * xp[:, i:i + h, j:j + w]
                out = term if out is None else out + term
    return out


def _derivatives(flow: torch.Tensor, calib: float) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    if flow.dim() not in (3, 4) or flow.shape[-1] != 2 or not flow.is_floating_point():
        raise ValueError(f"expected a float [H,W,2] or [B,H,W,2] flow, got {tuple(flow.shape)} {flow.dtype}")
    squeeze = flow.dim() == 3
    if squeeze:
        flow = flow[None]
    du = _correlate3(flow[..., 0], DY) / calib
    dv = _correlate3(flow[..., 1], DX) / calib
    return du, dv, squeeze


def calc_vorticity(flow: torch.Tensor, calib: float = 1.0):
    """``(vorticity, shear_strain, normal_strain)``: ``dv/dx - du/dy``, ``dv/dx + du/dy`` and
    its negative, each ``[H,W]`` or ``[B,H,W]``."""
    du, dv, squeeze = _derivatives(flow, calib)
    vort, shear, normal = dv - du, dv + du, -(dv + du)
    if squeeze:
        return vort[0], shear[0], normal[0]
    return vort, shear, normal


def de_vort(flow: torch.Tensor, calib: float = 1.0):
    """``(vorticity, du/dy, dv/dx)`` (the reference's explicit-stencil variant)."""
    du, dv, squeeze = _derivatives(flow, calib)
    vort = dv - du
    if squeeze:
        return vort[0], du[0], dv[0]
    return vort, du, dv
