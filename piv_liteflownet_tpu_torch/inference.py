"""The ``estimate()`` contract (port of ``piv_liteflownet_tpu/inference.py:estimate``).

1. both frames are cast to the dtype of the model's parameters (float32, or
   bfloat16 for the fast path) and resized bilinearly (align_corners=False)
   to the next multiple of 32;
2. one eval forward gives the scaled flow, float32 convs in full float32;
3. the flow is resized back to the input size, u scaled by W_in/W_32 and v
   by H_in/H_32, all in that dtype.

Inputs and outputs keep the JAX package's NHWC layout.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, LiteFlowNet, Ops
from piv_liteflownet_tpu_torch.ops.nn import f32_convs
from piv_liteflownet_tpu_torch.ops.resize import resize_bilinear


def adaptive_size(h: int, w: int, mult: int = 32) -> Tuple[int, int]:
    return int(math.ceil(h / mult) * mult), int(math.ceil(w / mult) * mult)


def to_nchw(img, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[B,H,W,C]`` numpy or tensor -> contiguous ``[B,C,H,W]`` of ``dtype`` on ``device``."""
    t = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.asarray(img, np.float32))
    return t.to(device=device, dtype=dtype).permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def estimate(model: LiteFlowNet, img1, img2, tensor: bool = False, ops: Ops = KERNEL_OPS):
    """Flow for one pair or a batch of pairs.

    img1/img2: ``[H,W,3]`` or ``[B,H,W,3]`` in [0, 1] (numpy or torch).
    Everything runs in the dtype of the model's parameters, as in the JAX
    package: float32, or bfloat16 after ``model.to(torch.bfloat16)`` (bf16
    convs through cuDNN, which sums in float32, or with ``conv_impl="chain"``
    the conv chain's bf16 form; the kernels' bf16 forms).
    Returns a ``[B,H,W,2]`` torch tensor of that dtype on the model's device
    (with ``tensor=True`` or a batch), else an ``[H,W,2]`` numpy array: of
    float32 for a bf16 model, holding the bf16 values exactly, because torch
    exports no bf16 to numpy (JAX returns an ``ml_dtypes`` bf16 array).
    ``ops`` selects the kernels (default) or their plain versions. float32
    convs run in full float32 whatever torch's TF32 flags say.
    """
    if tuple(img1.shape) != tuple(img2.shape):
        raise ValueError(f"both frames must have the same shape, got "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    single = len(img1.shape) == 3
    if single:
        img1, img2 = img1[None], img2[None]
    if len(img1.shape) != 4 or img1.shape[-1] != 3:
        raise ValueError(f"expected [H,W,3] or [B,H,W,3] frames, got {tuple(img1.shape)}")
    param = next(model.parameters())
    device, dtype = param.device, param.dtype
    x1, x2 = to_nchw(img1, device, dtype), to_nchw(img2, device, dtype)
    in_h, in_w = x1.shape[2], x1.shape[3]
    ah, aw = adaptive_size(in_h, in_w)
    with f32_convs():
        flow = model(resize_bilinear(x1, ah, aw), resize_bilinear(x2, ah, aw), ops)
    flow = resize_bilinear(flow, in_h, in_w)
    scale = torch.tensor([in_w / aw, in_h / ah], dtype=flow.dtype, device=device)
    flow = (flow * scale.view(1, 2, 1, 1)).permute(0, 2, 3, 1)
    if tensor or not single:
        return flow
    return flow[0].float().cpu().numpy()
