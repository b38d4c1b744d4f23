"""Checkpoint and resume with ``torch.save``.

Port of ``piv_liteflownet_tpu/utils/checkpoint.py`` with its file names:
``<prefix>_checkpoint`` at every validation, copied to ``<prefix>_model_best``
on an improvement, ``backup_<epoch>`` periodically, and a ``.meta.json``
beside each. A checkpoint is one file holding ``{"model": state dict,
"optimizer": state dict, "epoch", "best_epe", "step"}``.

``save_params_npz``/``load_params_npz`` exchange bare weights with the JAX
package: an ``.npz`` of its params (torch names, JAX layouts), converted by
``models/convert.py``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch


def save_checkpoint(state: Dict[str, Any], is_best: bool, path: str, prefix: str,
                    filename: Optional[str] = None,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    """Save ``state`` as ``<path>/<prefix>_checkpoint`` (or ``filename``); copy it to
    ``<prefix>_model_best`` when ``is_best``. Returns the file's path."""
    os.makedirs(path, exist_ok=True)
    target = os.path.abspath(os.path.join(path, filename or f"{prefix}_checkpoint"))
    tmp = target + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, target)
    if metadata is not None:
        with open(target + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)
    if is_best:
        best = os.path.abspath(os.path.join(path, f"{prefix}_model_best"))
        shutil.copyfile(target, best)
        if metadata is not None:
            shutil.copyfile(target + ".meta.json", best + ".meta.json")
    return target


def restore_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
    """Load a checkpoint written by :func:`save_checkpoint` (tensors onto ``map_location``)."""
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)


def load_metadata(path: str) -> Optional[Dict[str, Any]]:
    meta = os.path.abspath(path) + ".meta.json"
    if os.path.isfile(meta):
        with open(meta) as f:
            return json.load(f)
    return None


def save_params_npz(cfg, state_dict, path: str) -> None:
    """Write a model's state dict as the JAX package's ``.npz`` of params (JAX layouts)."""
    from piv_liteflownet_tpu_torch.models.convert import to_jax_params

    np.savez(path, **to_jax_params(cfg, state_dict))


def load_params_npz(cfg, path: str) -> Dict[str, torch.Tensor]:
    """The state dict of ``cfg``'s model from an ``.npz`` of JAX params (``save_params_npz``,
    or the JAX package's own)."""
    from piv_liteflownet_tpu_torch.models.convert import from_jax_params

    with np.load(path) as f:
        return from_jax_params(cfg, {k: f[k] for k in f.files})
