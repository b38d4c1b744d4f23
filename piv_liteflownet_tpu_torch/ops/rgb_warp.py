"""Fused rgb backward warp + occlusion norm of NetE-R.

``norm = sqrt(sum_c (img1 - backwarp(img2, flow))^2)``: the port of
``piv_liteflownet_tpu/ops/pallas_rgb_warp.py:rgb_warp_norm_gather`` (the exact
value of the TPU kernel ``rgb_warp_norm_pallas`` and its guarded form
``rgb_warp_norm``). NCHW here: ``img1, img2 [B,3,H,W]``, ``flow [B,2,H,W]``
-> ``[B,1,H,W]``.

``rgb_warp_norm`` launches the CUDA kernel ``csrc/rgb_warp_norm.cu`` for CUDA
tensors (bound by bytes; the warped rgb never stored; a lane of a warp takes
:func:`pixels_a_lane` pixels of a row, 32 apart) and takes
:func:`rgb_warp_norm_plain` for CPU tensors. It has no gradient on either
path, as in JAX (``stop_gradient`` on the norm, and a zero tangent for the TPU
kernel): its output never requires grad, whatever its inputs do.

Both paths keep the operands' dtype, float32 or bfloat16 (JAX: output in
img1's dtype). The kernel's bf16 form (``pivk_rgb_warp_norm_bf16``) keeps the
warp and the squared sum in float32 and rounds once on store. Both forms read
a NaN or huge sample point as outside the map (zeros), as the plain version
does.
"""

from __future__ import annotations

import torch

from piv_liteflownet_tpu_torch import kernels
from piv_liteflownet_tpu_torch.ops.warp import backwarp_plain

#: Kernel launches made by :func:`rgb_warp_norm` (plain-path calls do not count): the float32 form.
launches = 0
#: Launches of the kernel's bfloat16 form.
bf16_launches = 0

#: Pixels (``B * H * W``) from which a lane of the kernel takes two pixels instead of one
#: (``LANES2_MIN_PIXELS`` in ``csrc/rgb_warp_norm.cu``).
LANES2_MIN_PIXELS = 1 << 17


def pixels_a_lane(b: int, h: int, w: int) -> int:
    """The pixels a lane of the kernel takes at ``[b,3,h,w]``: 2 on large maps, 1 on small ones."""
    return 2 if b * h * w >= LANES2_MIN_PIXELS else 1


def rgb_warp_norm_plain(img1: torch.Tensor, img2: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    d = img1 - backwarp_plain(img2, flow)
    return torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))


def rgb_warp_norm(img1: torch.Tensor, img2: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Occlusion norm of ``img1`` against ``img2`` warped by ``flow``; kernel on CUDA, plain on the CPU.

    All three float32 or all bfloat16; the result has their dtype. No gradient: the result is
    detached from the inputs on both paths.
    """
    if (img1.dim() != 4 or img1.shape[1] != 3 or img2.shape != img1.shape
            or tuple(flow.shape) != (img1.shape[0], 2, *img1.shape[2:])):
        raise ValueError(f"rgb_warp_norm: expected [B,3,H,W] x 2 and [B,2,H,W], got "
                         f"{tuple(img1.shape)}, {tuple(img2.shape)}, {tuple(flow.shape)}")
    if not kernels.on_cuda("rgb_warp_norm", img1, img2, flow):
        with torch.no_grad():
            return rgb_warp_norm_plain(img1, img2, flow)
    global launches, bf16_launches
    b, _, h, w = img1.shape
    out = torch.empty((b, 1, h, w), device=img1.device, dtype=img1.dtype)
    if out.numel() == 0:
        return out
    with torch.no_grad():
        _launch(img1, img2, flow, out)
    if img1.dtype == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return out


def _launch(img1: torch.Tensor, img2: torch.Tensor, flow: torch.Tensor, out: torch.Tensor) -> None:
    """The kernel call itself (a test can substitute a fake)."""
    b, _, h, w = img1.shape
    kernels.launch(kernels.entry("rgb_warp_norm", img1.dtype), "rgb_warp_norm", img1.device,
                   img1.data_ptr(), img2.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w)
