"""Model factories (port of ``piv_liteflownet_tpu/models/factory.py``), versions 1 and 2."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from piv_liteflownet_tpu_torch.models.liteflownet import LiteFlowNet, ModelConfig

HUI_MEAN = (0.411618, 0.434631, 0.454253, 0.410782, 0.433645, 0.452793)  # Hui 2018
PIV_MEAN_V1 = (0.173935, 0.180594, 0.192608, 0.172978, 0.179518, 0.191300)  # Cai 2019
PIV_MEAN_V2 = (0.194286, 0.190633, 0.191766, 0.194220, 0.190595, 0.191701)  # Silitonga 2020

HUI_V1 = ModelConfig(version=1, starting_scale=40, lowest_level=2, rgb_mean=HUI_MEAN)
HUI_V2 = ModelConfig(version=2, starting_scale=40, lowest_level=3, rgb_mean=HUI_MEAN)
PIV_V1 = ModelConfig(version=1, starting_scale=10, lowest_level=1, rgb_mean=PIV_MEAN_V1)
PIV_V2 = ModelConfig(version=2, starting_scale=10, lowest_level=2, rgb_mean=PIV_MEAN_V2)
CONFIGS = {("hui", 1): HUI_V1, ("hui", 2): HUI_V2, ("piv", 1): PIV_V1, ("piv", 2): PIV_V2}


def model_config_registry():
    """Name -> ``ModelConfig`` factory, whose signatures the trainer reflects into its
    ``--model_*`` flags."""

    def LiteFlowNet(starting_scale=10.0, lowest_level=1, rgb_mean=list(PIV_MEAN_V1)):
        return ModelConfig(version=1, starting_scale=starting_scale, lowest_level=lowest_level,
                           rgb_mean=tuple(rgb_mean))

    def LiteFlowNet2(starting_scale=10.0, lowest_level=2, rgb_mean=list(PIV_MEAN_V2)):
        return ModelConfig(version=2, starting_scale=starting_scale, lowest_level=lowest_level,
                           rgb_mean=tuple(rgb_mean))

    return {"LiteFlowNet": LiteFlowNet, "LiteFlowNet2": LiteFlowNet2}


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def config(family: str, version: int, conv_impl: str = "cudnn") -> ModelConfig:
    """The ``ModelConfig`` of ``family`` ("hui" or "piv") and ``version`` (1 or 2)."""
    if version not in (1, 2):
        raise ValueError(
            f"Wrong input of model version (input = {version})! Choose between version 1 or 2 only!")
    return dataclasses.replace(CONFIGS[family, version], conv_impl=conv_impl)


def _build(cfg: ModelConfig, params: Optional[Mapping], seed: int, device) -> LiteFlowNet:
    dev = resolve_device(device)
    model = LiteFlowNet(cfg)
    if params is None:
        model.init_parameters(torch.Generator().manual_seed(seed))
    else:
        state = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v, np.float32))
                 for k, v in params.items()}
        model.load_state_dict(state, strict=True)
    return model.to(dev).eval()


def hui_liteflownet(params: Optional[Mapping] = None, version: int = 1, seed: int = 0,
                    device=None, conv_impl: str = "cudnn") -> LiteFlowNet:
    """Original LiteFlowNet (Hui 2018) / LiteFlowNet2 (Hui 2020).

    ``params``: a torch state dict (tensors or arrays), or ``None`` for a
    seeded random init. ``device``: ``None`` means the CUDA card.
    ``conv_impl``: see ``ModelConfig``; "chain" runs the eval forward's
    NetE conv stacks through the ``conv_chain`` kernel.
    """
    return _build(config("hui", version, conv_impl), params, seed, device)


def piv_liteflownet(params: Optional[Mapping] = None, version: int = 1, seed: int = 0,
                    device=None, conv_impl: str = "cudnn") -> LiteFlowNet:
    """PIV-LiteFlowNet-en (Cai 2019) / PIV-LiteFlowNet2-en (Silitonga 2020); arguments as
    :func:`hui_liteflownet`."""
    return _build(config("piv", version, conv_impl), params, seed, device)
