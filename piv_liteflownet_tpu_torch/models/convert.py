"""JAX params <-> the port's torch state dict, and upstream ``.paramOnly`` files.

The JAX package keys its params with the torch state-dict names, in JAX
layouts (``piv_liteflownet_tpu/models/convert.py:to_torch_state_dict``):

- ``Conv2d.weight``: HWIO -> OIHW;
- depthwise ``ConvTranspose2d.weight`` (``upConv_M``, ``upCorr_M``): the JAX
  copy is spatially flipped ``(kH, kW, 1, C)``; torch's is ``(C, 1, kH, kW)``
  unflipped;
- biases unchanged.

The upstream repository ships weights as ``.paramOnly`` torch state dicts,
whose names and layouts are the port's own: ``load_param_only`` checks them.
``rename_caffe_keys`` maps a Caffe export onto those names by position, and
``validate_params`` checks a state dict's keys and shapes. The converter CLI
is ``python -m piv_liteflownet_tpu_torch.convert``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping

import numpy as np
import torch

from piv_liteflownet_tpu_torch.models.liteflownet import ModelConfig, param_shapes


def _expected(cfg: ModelConfig) -> Iterator[tuple]:
    """(name, torch shape) of every tensor of ``cfg``'s state dict."""
    for spec in param_shapes(cfg):
        groups = spec["transpose_groups"]
        yield spec["name"] + ".weight", (spec["cout"], spec["cin"] // (groups or 1), spec["kh"], spec["kw"])
        if spec["bias"]:
            yield spec["name"] + ".bias", (spec["cout"],)


def load_param_only(cfg: ModelConfig, path: str) -> Dict[str, torch.Tensor]:
    """A ``.paramOnly`` torch state dict, its names and shapes checked against ``cfg``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    out: Dict[str, torch.Tensor] = {}
    missing = []
    for name, shape in _expected(cfg):
        if name not in state:
            missing.append(name)
            continue
        t = torch.as_tensor(state[name], dtype=torch.float32)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        out[name] = t.contiguous()
    if missing:
        raise KeyError(f"state dict is missing {len(missing)} keys, e.g. {missing[:5]}")
    return out


def to_jax_params(cfg: ModelConfig, state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`from_jax_params`: numpy params in JAX layouts."""
    out: Dict[str, np.ndarray] = {}
    for spec in param_shapes(cfg):
        name = spec["name"]
        w = state_dict[name + ".weight"].detach().float().cpu().numpy()
        if spec["transpose_groups"] is not None:
            w = w[:, :, ::-1, ::-1]
        out[name + ".weight"] = np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
        if spec["bias"]:
            out[name + ".bias"] = state_dict[name + ".bias"].detach().float().cpu().numpy()
    return out


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


def expected_keys(cfg: ModelConfig) -> List[str]:
    """The state dict's keys for ``cfg``, in the model's order."""
    return [name for name, _ in _expected(cfg)]


def rename_caffe_keys(cfg: ModelConfig, caffe_dict: Mapping[str, object]) -> Dict[str, object]:
    """Rename a Caffe export's tensors onto ``cfg``'s state-dict keys by position: the entries
    whose key names a weight or a bias, in the export's order, zipped onto
    :func:`expected_keys`. Raises if their counts differ."""
    filtered = [(k, v) for k, v in caffe_dict.items()
                if k.endswith("weight") or k.endswith("bias") or ".weight" in k or ".bias" in k]
    targets = expected_keys(cfg)
    if len(filtered) != len(targets):
        raise ValueError(f"Caffe dict has {len(filtered)} tensors but model expects {len(targets)}")
    return {t: v for t, (_, v) in zip(targets, filtered)}


def validate_params(cfg: ModelConfig, state_dict: Mapping[str, object]) -> None:
    """Check a state dict's key set and torch shapes against ``cfg``; raise on a mismatch."""
    want = dict(_expected(cfg))
    got = set(state_dict.keys())
    if set(want) != got:
        miss, extra = sorted(set(want) - got)[:5], sorted(got - set(want))[:5]
        raise ValueError(f"param key mismatch; missing={miss} extra={extra}")
    for name, shape in want.items():
        if tuple(state_dict[name].shape) != shape:
            raise ValueError(f"{name} shape {tuple(state_dict[name].shape)} != {shape}")
