"""The training step on one device: forward, multiscale loss, backward, optimizer step.

Port of ``piv_liteflownet_tpu/parallel/train_step.py`` for one GPU (or the
CPU). Inputs keep the JAX package's layout: ``img1, img2 [B,H,W,3]`` in
[0, 1] and ``target [B,H,W,2]``, the raw (undivided) flow, as numpy arrays
or tensors; they are moved to the model's device. The step updates the
model and the optimizer in place and returns the loss and EPE as 0-dim
tensors on the device, so that the caller chooses when to read them back.

Not ported yet (ROADMAP.md): ``mesh`` (data-parallel over several cards),
``pipeline`` (on-device augmentation), ``remat`` and ``compute_dtype``
(bf16 compute; the kernels take float32 only).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from piv_liteflownet_tpu_torch.inference import to_nchw
from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, LiteFlowNet, ModelConfig, Ops
from piv_liteflownet_tpu_torch.ops.nn import f32_convs
from piv_liteflownet_tpu_torch.ops.resize import avg_pool
from piv_liteflownet_tpu_torch.training.loss import EPE


@dataclasses.dataclass
class TrainState:
    model: LiteFlowNet
    optimizer: torch.optim.Optimizer
    step: int = 0


def _summed(value):
    # LevelLoss returns per-level lists; training takes their sum
    return sum(value) if isinstance(value, (tuple, list)) else value


def _not_ported(**options) -> None:
    for name, value in options.items():
        if value:
            raise NotImplementedError(f"make_train_step({name}=...) is not ported yet; see ROADMAP.md")


def make_train_step(cfg: ModelConfig, loss_obj, optimizer: torch.optim.Optimizer,
                    ops: Ops = KERNEL_OPS, mesh=None, pipeline=None, remat: bool = False,
                    compute_dtype=None) -> Callable:
    """Build ``step(state, img1, img2, target) -> (state, {"loss", "epe"})``.

    ``ops`` picks the kernels (default) or their plain versions (``PLAIN_OPS``). The
    forward and backward convs run in full float32 whatever torch's TF32 flags say.
    """
    _not_ported(mesh=mesh, pipeline=pipeline, remat=remat,
                compute_dtype=compute_dtype not in (None, torch.float32))

    def step(state: TrainState, img1, img2, target):
        if state.optimizer is not optimizer:
            raise ValueError("the state's optimizer is not the one this step was built with")
        model = state.model
        if model.cfg != cfg:
            raise ValueError(f"the state's model has config {model.cfg}, the step {cfg}")
        device = next(model.parameters()).device
        x1, x2, t = (to_nchw(a, device) for a in (img1, img2, target))
        optimizer.zero_grad(set_to_none=True)
        with f32_convs():
            lossvalue, epevalue = loss_obj(model(x1, x2, ops, train=True), t)
            lossvalue, epevalue = _summed(lossvalue), _summed(epevalue)
            lossvalue.backward()
        optimizer.step()
        state.step += 1
        return state, {"loss": lossvalue.detach(), "epe": epevalue.detach()}

    return step


def make_eval_step(cfg: ModelConfig, loss_obj) -> Callable:
    """Validation step ``(model, img1, img2, target) -> {"loss", "epe"}``: eval forward (float32
    convs, as in training) and loss."""

    @torch.no_grad()
    def step(model: LiteFlowNet, img1, img2, target) -> Dict[str, torch.Tensor]:
        if model.cfg != cfg:
            raise ValueError(f"the model has config {model.cfg}, the step {cfg}")
        device = next(model.parameters()).device
        x1, x2, t = (to_nchw(a, device) for a in (img1, img2, target))
        with f32_convs():
            out = model(x1, x2)
        try:
            lossvalue, epevalue = loss_obj(out, t)
        except ValueError:
            # LevelLoss has no eval branch: score the final flow against the
            # target pooled by startScale, as MultiScale's eval branch does
            target_ = avg_pool(getattr(loss_obj, "div_scale", 1.0) * t,
                               getattr(loss_obj, "startScale", 1))
            epevalue = EPE(out, target_)
            lossvalue = epevalue
        return {"loss": _summed(lossvalue), "epe": _summed(epevalue)}

    return step
