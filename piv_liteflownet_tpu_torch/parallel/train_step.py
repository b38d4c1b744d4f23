"""The training step: forward, multiscale loss, backward, optimizer step, on one device or data-parallel.

Port of ``piv_liteflownet_tpu/parallel/train_step.py``. Inputs keep the JAX
package's layout: ``img1, img2 [B,H,W,3]`` in [0, 1] and ``target
[B,H,W,2]``, the raw (undivided) flow, as numpy arrays
or tensors; they are moved to the model's device. The step updates the
model and the optimizer in place and returns the loss and EPE as 0-dim
tensors on the device, so that the caller chooses when to read them back.

With ``pipeline`` (``data/transforms.py:Pipeline``) the step first augments
and crops the batch on the model's device, as JAX ``parallel/train_step.py:87-89``
does. Its random factors come from the step's ``rng`` argument, a seed or a
``torch.Generator``, never from a global generator; a seed makes a generator
on the model's device.

``compute_dtype=torch.bfloat16`` is mixed precision, as in JAX
``parallel/train_step.py:56-74``: the float32 master params are cast to bf16
at the forward boundary with ``.to`` (differentiable, so autograd returns
float32 gradients into them), the images are cast too, the forward and
backward run in bf16 (cuDNN's bf16 convs, the kernels' ``_bf16`` forms), the
outputs go back to float32 before the loss, and the loss and the optimizer
state stay float32. Not ``torch.autocast``, which keeps some ops in float32
and casts per op: another function than JAX's.

``remat=True`` checkpoints each module call of the forward
(``LiteFlowNet.forward(remat=True)``): the backward recomputes the
activations, in float32 and in the mixed bf16 step, under the same
``f32_convs`` pinning as the forward. The gradients are the same function.

``mesh`` (``parallel/mesh.py``, one rank a device) makes the step
data-parallel, as JAX's step jitted over a ``data`` mesh: each rank's step
takes its rows of the global batch and runs the forward and backward on them;
then one all-reduce sums the float32 gradients, each weighted by its rank's
rows, with the loss, the EPE and the row counts, so that every rank applies
the gradient of the global batch's mean loss (JAX's ``psum``) and returns the
global loss and EPE. The all-reduce is made by hand, not by
``DistributedDataParallel``, whose reducer needs its own ``forward``: the bf16
step calls the model through ``functional_call`` and remat through
``checkpoint``. Building the step broadcasts rank 0's parameters, and equal
gradients keep the ranks' parameters and optimizer states equal. With a
``pipeline`` every rank draws the factors of the whole global batch from the
same seed (``N x`` its rows) and applies its own rows' factors, as JAX's step
augments the global batch; the ranks' rows must then be equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from piv_liteflownet_tpu_torch.data.transforms import apply_pipeline, augment, draw_params
from piv_liteflownet_tpu_torch.inference import to_nchw
from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, LiteFlowNet, ModelConfig, Ops
from piv_liteflownet_tpu_torch.ops.nn import f32_convs
from piv_liteflownet_tpu_torch.ops.resize import avg_pool
from piv_liteflownet_tpu_torch.parallel.mesh import Mesh, all_reduce, broadcast, split_rows
from piv_liteflownet_tpu_torch.training.loss import EPE
from piv_liteflownet_tpu_torch.utils.profiling import (STEP, STEP_ALLREDUCE, STEP_AUGMENT, STEP_BACKWARD, STEP_LOSS,
                                                       STEP_OPTIMIZER, span)


@dataclasses.dataclass
class TrainState:
    model: LiteFlowNet
    optimizer: torch.optim.Optimizer
    step: int = 0


def _summed(value):
    # LevelLoss returns per-level lists; training takes their sum
    return sum(value) if isinstance(value, (tuple, list)) else value


def _on(a, device: torch.device) -> torch.Tensor:
    """An NHWC numpy array or tensor as a float32 tensor on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float32))
    return t.to(device=device, dtype=torch.float32)


def _forward(model: LiteFlowNet, x1, x2, ops: Ops, compute_dtype, remat: bool):
    """The train forward, in ``compute_dtype`` (None: the params' float32) with float32 outputs."""
    if compute_dtype is None:
        return model(x1, x2, ops, train=True, remat=remat)
    params = {n: p.to(compute_dtype) for n, p in model.named_parameters()}
    out = functional_call(model, params, (x1.to(compute_dtype), x2.to(compute_dtype), ops),
                          {"train": True, "remat": remat})
    return [[o.float() for o in level] for level in out]


def _draws(pipeline, rng, img1, img2, target, mesh: Optional[Mesh]):
    """The augmented batch: with a mesh, this rank's rows of the draws for the global batch."""
    if mesh is None:
        return apply_pipeline(rng, img1, img2, target, pipeline)
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator(device=img1.device).manual_seed(int(rng))
    b, h, w = img1.shape[:3]
    params = draw_params(pipeline, b * mesh.size, h, w, rng)
    rows = split_rows(b * mesh.size, mesh.size, mesh.rank)
    return augment({k: v[rows] for k, v in params.items()}, img1, img2, target, pipeline)


def _global_means(mesh: Mesh, rows: int, values: List[torch.Tensor], grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """``values`` (0-dim) and ``grads`` averaged over the ranks, each rank weighted by its
    ``rows``, in one all-reduce; the gradients are written back in place."""
    dev = values[0].device
    body = torch.cat([g.reshape(-1) for g in grads] + [v.detach().float().reshape(1) for v in values]) * rows
    flat = all_reduce(mesh, torch.cat([body, torch.full((1,), float(rows), device=dev)]))
    flat = flat[:-1] / flat[-1]
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return [flat[at + i] for i in range(len(values))]


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (one rank a device), got {type(mesh).__name__}")


def make_train_step(cfg: ModelConfig, loss_obj, optimizer: torch.optim.Optimizer,
                    ops: Ops = KERNEL_OPS, mesh: Optional[Mesh] = None, pipeline=None, remat: bool = False,
                    compute_dtype=None) -> Callable:
    """Build ``step(state, img1, img2, target, rng=None) -> (state, {"loss", "epe"})``.

    With ``pipeline`` the step augments the batch on the model's device first, drawing from
    ``rng`` (a seed or a ``torch.Generator``; required). ``ops`` picks the kernels (default)
    or their plain versions (``PLAIN_OPS``). The forward and backward convs run in full
    float32 whatever torch's TF32 flags say; with ``remat`` the backward's recompute too.
    ``compute_dtype``: None or ``torch.float32`` (the float32 step) or ``torch.bfloat16``
    (mixed precision, the module docstring); the kernels take no other dtype. The step
    carries it as ``step.compute_dtype`` (``torch.float32`` for the float32 step).
    ``mesh``: data-parallel over its ranks (the module docstring): the step takes this rank's
    rows and returns the global batch's loss and EPE; building it broadcasts rank 0's
    parameters, so every rank must build it.
    """
    _check_mesh(mesh)
    if compute_dtype == torch.float32:
        compute_dtype = None
    if compute_dtype not in (None, torch.bfloat16):
        raise NotImplementedError(f"make_train_step(compute_dtype={compute_dtype}): the kernels take "
                                  "float32 and bfloat16 only; see ROADMAP.md")
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if mesh is not None:
        with torch.no_grad():
            flat = broadcast(mesh, torch.cat([p.reshape(-1) for p in params]))
            at = 0
            for p in params:
                p.copy_(flat[at:at + p.numel()].view_as(p))
                at += p.numel()

    def step(state: TrainState, img1, img2, target, rng=None):
        with span(STEP):
            if state.optimizer is not optimizer:
                raise ValueError("the state's optimizer is not the one this step was built with")
            model = state.model
            if model.cfg != cfg:
                raise ValueError(f"the state's model has config {model.cfg}, the step {cfg}")
            device = next(model.parameters()).device
            with span(STEP_AUGMENT):
                if pipeline is not None:
                    if rng is None:
                        raise ValueError("a step with a pipeline needs rng, a seed or a torch.Generator")
                    img1, img2, target = _draws(pipeline, rng, *(_on(a, device) for a in (img1, img2, target)), mesh)
                x1, x2, t = (to_nchw(a, device) for a in (img1, img2, target))
            optimizer.zero_grad(set_to_none=True)
            with f32_convs():
                out = _forward(model, x1, x2, ops, compute_dtype, remat)
                with span(STEP_LOSS):
                    lossvalue, epevalue = loss_obj(out, t)
                    lossvalue, epevalue = _summed(lossvalue), _summed(epevalue)
                del out  # the outputs are not held through the backward
                with span(STEP_BACKWARD):
                    lossvalue.backward()
            lossvalue, epevalue = lossvalue.detach(), epevalue.detach()
            if mesh is not None:
                grads = [p.grad for p in params if p.grad is not None]
                with span(STEP_ALLREDUCE):
                    lossvalue, epevalue = _global_means(mesh, x1.shape[0], [lossvalue, epevalue], grads)
            with span(STEP_OPTIMIZER):
                optimizer.step()
            state.step += 1
            return state, {"loss": lossvalue, "epe": epevalue}

    step.compute_dtype = compute_dtype or torch.float32
    return step


def make_eval_step(cfg: ModelConfig, loss_obj, mesh: Optional[Mesh] = None) -> Callable:
    """Validation step ``(model, img1, img2, target) -> {"loss", "epe"}``: eval forward (float32
    convs, as in training) and loss. With ``mesh`` it takes this rank's rows and returns the
    global batch's loss and EPE (the ranks' means weighted by their rows)."""
    _check_mesh(mesh)

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
            # LevelLoss has no eval branch: score the final flow against the target pooled by
            # startScale, as MultiScale's eval branch does
            target_ = avg_pool(getattr(loss_obj, "div_scale", 1.0) * t,
                               getattr(loss_obj, "startScale", 1))
            epevalue = EPE(out, target_)
            lossvalue = epevalue
        lossvalue, epevalue = _summed(lossvalue), _summed(epevalue)
        if mesh is not None:
            lossvalue, epevalue = _global_means(mesh, x1.shape[0], [lossvalue, epevalue], [])
        return {"loss": lossvalue, "epe": epevalue}

    return step
