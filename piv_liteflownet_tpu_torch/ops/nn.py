"""Small NCHW ops of the model, ports of ``piv_liteflownet_tpu/ops/nn.py``."""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator

import torch
import torch.nn.functional as F

NEGATIVE_SLOPE = 0.1


@functools.lru_cache(maxsize=256)
def device_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The 1-D tensor of ``values`` on ``device``, made on the first call and kept: a tensor
    built from host values is a blocking copy, which waits for the work queued on the stream
    and so keeps the host from launching ahead of the card. Never write into it."""
    return torch.tensor(values, dtype=dtype, device=device)


@contextlib.contextmanager
def f32_convs() -> Iterator[None]:
    """Run cuDNN convs in full float32 (TF32 off), as the JAX package runs its f32 convs at
    ``Precision.HIGHEST``; restores the caller's setting on exit. Only ``allow_tf32`` is
    touched, through the legacy flag (mixing it with ``cudnn.conv.fp32_precision`` makes
    later reads of the legacy flag raise)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


@contextlib.contextmanager
def f32_matmuls() -> Iterator[None]:
    """Run CUDA matmuls in full float32 (TF32 off) and restore the caller's setting, through
    the legacy ``torch.backends.cuda.matmul.allow_tf32`` flag, as :func:`f32_convs` does."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``LeakyReLU(0.1)`` (port of ``leaky_relu``)."""
    return F.leaky_relu(x, NEGATIVE_SLOPE)


def depthwise_deconv4x2(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose2d(C, C, 4, stride=2, padding=1, groups=C, bias=False)``.

    ``weight`` is the torch layout ``(C, 1, 4, 4)``, not flipped (port of
    ``depthwise_deconv4x2``, whose JAX weight is the flipped ``(4, 4, 1, C)``).
    """
    return F.conv_transpose2d(x, weight, stride=2, padding=1, groups=x.shape[1])


def unfold(x: torch.Tensor, k: int) -> torch.Tensor:
    """``k*k`` zero-padded patches of a ``[B,1,H,W]`` map as ``[B,k*k,H,W]``.

    Port of ``unfold_nhwc``: ``F.unfold`` order, patch ``d = dy*k + dx``.
    """
    b, c, h, w = x.shape
    if c != 1:
        raise ValueError(f"unfold: expected one channel, got {c}")
    return F.unfold(x, k, padding=(k - 1) // 2).view(b, k * k, h, w)
