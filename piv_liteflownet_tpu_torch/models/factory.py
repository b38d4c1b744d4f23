"""Model factories (port of ``piv_liteflownet_tpu/models/factory.py``), version 1."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from piv_liteflownet_tpu_torch.models.liteflownet import LiteFlowNet, ModelConfig

HUI_MEAN = (0.411618, 0.434631, 0.454253, 0.410782, 0.433645, 0.452793)  # Hui 2018
PIV_MEAN_V1 = (0.173935, 0.180594, 0.192608, 0.172978, 0.179518, 0.191300)  # Cai 2019

HUI_V1 = ModelConfig(version=1, starting_scale=40, lowest_level=2, rgb_mean=HUI_MEAN)
PIV_V1 = ModelConfig(version=1, starting_scale=10, lowest_level=1, rgb_mean=PIV_MEAN_V1)


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def check_version(version: int) -> None:
    """Raise unless ``version`` is the ported version 1."""
    if version == 2:
        raise NotImplementedError(
            "LiteFlowNet2 (version=2) is not ported yet; see ROADMAP.md")
    if version != 1:
        raise ValueError(
            f"Wrong input of model version (input = {version})! Choose between version 1 or 2 only!")


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
                    device=None) -> LiteFlowNet:
    """Original LiteFlowNet (Hui 2018).

    ``params``: a torch state dict (tensors or arrays), or ``None`` for a
    seeded random init. ``device``: ``None`` means the CUDA card.
    """
    check_version(version)
    return _build(HUI_V1, params, seed, device)


def piv_liteflownet(params: Optional[Mapping] = None, version: int = 1, seed: int = 0,
                    device=None) -> LiteFlowNet:
    """PIV-LiteFlowNet-en (Cai 2019); arguments as :func:`hui_liteflownet`."""
    check_version(version)
    return _build(PIV_V1, params, seed, device)
