"""The state dict of a JAX-layout ``.npz`` of the model's parameters, read with numpy alone.

The file keys each tensor by its torch name. A conv's weight is stored HWIO and becomes
OIHW; a depthwise deconv's (``upConv_M``, ``upCorr_M``) is stored spatially flipped as
``(kH, kW, 1, C)`` and becomes ``(C, 1, kH, kW)`` unflipped; biases are unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

DECONVS = (".upConv_M.", ".upCorr_M.")


def load_npz(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    out = {}
    with np.load(path) as f:
        for name in f.files:
            a = np.asarray(f[name], np.float32)
            if name.endswith(".weight"):
                a = np.transpose(a, (3, 2, 0, 1))
                if any(d in name for d in DECONVS):
                    a = a[:, :, ::-1, ::-1]
            out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out
