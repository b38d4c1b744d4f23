"""JAX params -> the port's torch state dict.

The JAX package keys its params with the torch state-dict names, in JAX
layouts (``piv_liteflownet_tpu/models/convert.py:to_torch_state_dict``):

- ``Conv2d.weight``: HWIO -> OIHW;
- depthwise ``ConvTranspose2d.weight`` (``upConv_M``, ``upCorr_M``): the JAX
  copy is spatially flipped ``(kH, kW, 1, C)``; torch's is ``(C, 1, kH, kW)``
  unflipped;
- biases unchanged.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from piv_liteflownet_tpu_torch.models.liteflownet import ModelConfig, param_shapes


def from_jax_params(cfg: ModelConfig, params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Convert a flat JAX param dict (numpy values) into a torch state dict for ``cfg``."""
    missing = [k for spec in param_shapes(cfg)
               for k in [spec["name"] + ".weight"] + ([spec["name"] + ".bias"] if spec["bias"] else [])
               if k not in params]
    if missing:
        raise KeyError(f"params are missing {len(missing)} keys, e.g. {missing[:5]}")
    out: Dict[str, torch.Tensor] = {}
    for spec in param_shapes(cfg):
        name = spec["name"]
        w = np.asarray(params[name + ".weight"], np.float32)
        groups = spec["transpose_groups"]
        want = (spec["kh"], spec["kw"], spec["cin"] // (groups or 1), spec["cout"])
        if w.shape != want:
            raise ValueError(f"{name}.weight has shape {w.shape}, expected {want}")
        w = np.transpose(w, (3, 2, 0, 1))  # HWIO -> OIHW; (kH,kW,1,C) -> (C,1,kH,kW)
        if groups is not None:
            w = w[:, :, ::-1, ::-1]
        out[name + ".weight"] = torch.from_numpy(w.copy())  # C order, writable
        if spec["bias"]:
            out[name + ".bias"] = torch.from_numpy(np.array(params[name + ".bias"], np.float32))
    return out
