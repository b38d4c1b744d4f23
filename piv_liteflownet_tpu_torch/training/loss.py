"""Multiscale training losses, NCHW.

Port of ``piv_liteflownet_tpu/training/loss.py``. Flows are ``[B,2,H,W]``.
The model's training output is a list over pyramid levels, coarsest first,
each a list of ``[flow_M, flow_S, flow_R]``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from piv_liteflownet_tpu_torch.ops.resize import avg_pool


def EPE(input_flow: torch.Tensor, target_flow: torch.Tensor, mean: bool = True) -> torch.Tensor:
    """End-point error: the mean (or the sum over the batch) of the L2 norm over the flow channels."""
    epe_map = torch.linalg.vector_norm(target_flow - input_flow, dim=1)
    if mean:
        return epe_map.mean()
    return epe_map.sum() / epe_map.shape[0]


def _l1(output, target, mean=True):
    loss_map = (output - target).abs()
    return loss_map.mean() if mean else loss_map.sum() / loss_map.shape[0]


def _l2(output, target, mean=True):
    loss_map = torch.linalg.vector_norm(output - target, dim=1)
    return loss_map.mean() if mean else loss_map.sum() / loss_map.shape[0]


@dataclasses.dataclass(frozen=True)
class L1Loss:
    mul_scale: float = 1.0
    loss_labels = ("L1", "EPE")

    def __call__(self, output, target):
        return [self.mul_scale * _l1(output, target), self.mul_scale * EPE(output, target)]


@dataclasses.dataclass(frozen=True)
class L2Loss:
    mul_scale: float = 1.0
    loss_labels = ("L2", "EPE")

    def __call__(self, output, target):
        return [self.mul_scale * _l2(output, target), self.mul_scale * EPE(output, target)]


@dataclasses.dataclass(frozen=True)
class MultiScale:
    """Pyramid-weighted multiscale loss.

    In training, entry ``i`` of the model's per-level list is compared with
    the target average-pooled by ``startScale * 2**(numScales-1-i)``; the
    target is first scaled by ``div_scale``. On a single (eval) flow it
    compares with the target pooled by ``startScale``.
    """

    div_scale: float = 0.05
    startScale: int = 2
    use_mean: bool = True
    l_weight: Tuple[float, ...] = (0.32, 0.08, 0.02, 0.01, 0.005)
    norm: str = "L1"

    @property
    def numScales(self) -> int:
        return 7 - self.startScale

    def _norm_fn(self, output, target):
        if self.norm == "L1":
            return _l1(output, target, self.use_mean)
        if self.norm == "L2":
            return _l2(output, target, self.use_mean)
        raise ValueError(f'Unknown "norm" ({self.norm})! Choose between L1 or L2 only!')

    def __call__(self, output, target):
        if isinstance(output, (tuple, list)):  # training mode
            if len(self.l_weight) != len(output):
                raise ValueError(f"{len(self.l_weight)} loss weights vs {len(output)} pyramid outputs")
            target = self.div_scale * target
            lossvalue = 0.0
            epevalue = 0.0
            for i, out_level in enumerate(output):
                if i < self.numScales:
                    target_ = avg_pool(target, self.startScale * (2 ** (self.numScales - 1 - i)))
                else:
                    target_ = target
                flows = out_level if isinstance(out_level, (tuple, list)) else [out_level]
                for f in flows:
                    epevalue = epevalue + self.l_weight[i] * EPE(f, target_, mean=self.use_mean)
                    lossvalue = lossvalue + self.l_weight[i] * self._norm_fn(f, target_)
            return [lossvalue, epevalue]
        target_ = avg_pool(target, self.startScale)
        return [self._norm_fn(output, target_), EPE(output, target_, mean=self.use_mean)]


@dataclasses.dataclass(frozen=True)
class LevelLoss:
    """Per-level diagnostic loss of each level's final (R) flow; lists of ``n_level`` values."""

    div_scale: float = 0.05
    startScale: int = 2
    n_level: int = 5
    norm: str = "L1"

    def __call__(self, output, target):
        if not isinstance(output, (tuple, list)):
            raise ValueError('The "output" type must be a list/tuple to perform per level evaluation!')
        if self.n_level != len(output):
            raise ValueError(f"n_level {self.n_level} vs {len(output)} pyramid outputs")
        target = self.div_scale * target
        norm_fn = _l1 if self.norm == "L1" else _l2
        lossvalue, epevalue = [], []
        for i, out_level in enumerate(output):
            target_ = avg_pool(target, self.startScale * (2 ** (self.n_level - 1 - i)))
            f = out_level[-1] if isinstance(out_level, (tuple, list)) else out_level
            epevalue.append(EPE(f, target_))
            lossvalue.append(norm_fn(f, target_))
        return [lossvalue, epevalue]


def hui_loss(level_eval: bool = False, mul_scale: float = 20, norm: str = "L1"):
    """The loss of Hui et al. 2018 (LiteFlowNet)."""
    if level_eval:
        return LevelLoss(div_scale=1 / mul_scale, norm=norm)
    return MultiScale(div_scale=1 / mul_scale, norm=norm)


def piv_loss(level_eval: bool = False, mul_scale: float = 5, norm: str = "L1", version: int = 1):
    """The loss of Cai et al. 2019 (PIV-LiteFlowNet-en), with its level weights."""
    if version == 1:
        loss_weight = (0.001, 0.001, 0.001, 0.001, 0.001, 0.01)
    elif version == 2:
        loss_weight = (0.001, 0.001, 0.001, 0.001, 0.01)
    else:
        raise ValueError(f'Unknown "version" ({version})! Choose between 1 or 2 only!')
    if level_eval:
        return LevelLoss(div_scale=1 / mul_scale, startScale=version, n_level=6, norm=norm)
    return MultiScale(div_scale=1 / mul_scale, startScale=version, l_weight=loss_weight, norm=norm)


def v2_multiscale(mul_scale: float = 5, norm: str = "L1") -> MultiScale:
    """A ``MultiScale`` that fits PIV-LiteFlowNet2-en's six training outputs (five levels and the
    full-size flow). ``piv_loss(version=2)`` has five weights and raises on them, as the JAX
    package asserts; this six-weight form is the recipe the JAX package trains version 2 with
    in its tests (``tests/test_training.py``)."""
    return MultiScale(div_scale=1 / mul_scale, startScale=2,
                      l_weight=(0.001, 0.001, 0.001, 0.001, 0.01, 0.01), norm=norm)
