"""Checkpoint and resume with ``torch.save``.

Port of ``piv_liteflownet_tpu/utils/checkpoint.py`` with its file names:
``<prefix>_checkpoint`` at every validation, copied to ``<prefix>_model_best``
on an improvement, ``backup_<epoch>`` periodically, and a ``.meta.json``
beside each. A checkpoint is one file holding ``{"model": state dict,
"optimizer": state dict, "epoch", "best_epe", "step"}``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

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
