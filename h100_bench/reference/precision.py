"""Lower precisions for the benchmark's control: the reference computed a step below the
precision its configuration states (float8 e4m3 for bfloat16, TF32 for float32)."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor (its largest magnitude
    to 448, as an fp8 matrix product scales its operands), back in float32."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (t.float() * scale).to(torch.float8_e4m3fn).float() / scale


QUANTIZERS = {"float32": None, "fp8": fp8}
