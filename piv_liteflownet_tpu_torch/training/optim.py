"""The optimizer with the four parameter groups of the reference, and the lr schedules.

Port of ``piv_liteflownet_tpu/training/optim.py``. The groups:

1. ``w_lo``: ``.weight`` of the NetE_{M,S,R} modules whose pyramid level is
   below 4 -> ``low_lr``, ``weight_decay``;
2. ``w_hi``: every other ``.weight`` -> ``lr``, ``weight_decay``;
3. ``b_lo``: ``.bias`` of NetE modules below level 4 -> ``low_lr``, ``bias_decay``;
4. ``b_hi``: every other ``.bias`` -> ``lr``, ``bias_decay``.

One ``torch.optim`` optimizer holds them, each group tagged with its label
under ``"name"``. Decay is torch's: L2 added to the gradient, or decoupled
for AdamW, as the JAX package's ``_group`` sets it. Schedules are pure
functions ``epoch -> lr``; :func:`set_group_lrs` writes them into the groups.
"""

from __future__ import annotations

import bisect
import inspect
import math
from typing import Dict, Iterable, Sequence

import torch

GROUPS = ("w_lo", "w_hi", "b_lo", "b_hi")

#: Optimizers of ``torch.optim`` that the JAX package's registry also has, by name.
OPTIMIZERS = {name: getattr(torch.optim, name) for name in (
    "Adam", "AdamW", "SGD", "RMSprop", "Adagrad", "Adadelta", "Adamax", "NAdam", "RAdam")}
#: Optimizers of the JAX package (optax) that ``torch.optim`` lacks; queued in ROADMAP.md.
NOT_PORTED = ("Lion", "Lamb", "Yogi", "Novograd")
#: Each optimizer of the JAX package's registry with its own arguments and their defaults,
#: as that registry names them: the trainer reflects these signatures into its
#: ``--optimizer_*`` flags and passes the set ones to :func:`make_optimizer`.
OPTIMIZER_ARGS = {
    "Adam": lambda betas=(0.9, 0.999), eps=1e-8, amsgrad=False: None,
    "AdamW": lambda betas=(0.9, 0.999), eps=1e-8, amsgrad=False: None,
    "SGD": lambda momentum=0.0, dampening=0.0, nesterov=False: None,
    "RMSprop": lambda alpha=0.99, eps=1e-8, momentum=0.0, centered=False: None,
    "Adagrad": lambda eps=1e-10: None,
    "Adadelta": lambda rho=0.9, eps=1e-6: None,
    "Adamax": lambda betas=(0.9, 0.999), eps=1e-8: None,
    "NAdam": lambda betas=(0.9, 0.999), eps=1e-8: None,
    "RAdam": lambda betas=(0.9, 0.999), eps=1e-8: None,
    "Lion": lambda betas=(0.9, 0.99): None,
    "Lamb": lambda betas=(0.9, 0.999), eps=1e-6: None,
    "Yogi": lambda betas=(0.9, 0.999), eps=1e-3: None,
    "Novograd": lambda betas=(0.9, 0.25), eps=1e-8: None,
}


def param_group_labels(names: Iterable[str], lowest_level: int) -> Dict[str, str]:
    """Label each parameter name with its group (``w_lo``, ``w_hi``, ``b_lo`` or ``b_hi``)."""
    low_ids = {i for i, level in enumerate(range(lowest_level, 7)) if level < 4}
    labels = {}
    for name in names:
        parts = name.split(".")
        is_bias = parts[-1] == "bias"
        in_low = parts[0].startswith("NetE") and len(parts) > 1 and int(parts[1]) in low_ids
        labels[name] = ("b" if is_bias else "w") + ("_lo" if in_low else "_hi")
    return labels


def _optimizer_class(name: str):
    for known, cls in OPTIMIZERS.items():
        if known.lower() == name.lower():
            return cls
    if any(n.lower() == name.lower() for n in NOT_PORTED):
        raise NotImplementedError(
            f"optimizer {name!r} is not in torch.optim and is not ported yet; see ROADMAP.md")
    raise ValueError(f"unknown optimizer {name!r}; available: {sorted(OPTIMIZERS)}")


def make_optimizer(model: torch.nn.Module, lowest_level: int, optimizer: str = "Adam",
                   lr: float = 1e-3, low_lr: float = 6e-5, weight_decay: float = 4e-4,
                   bias_decay: float = 0.0, **kw) -> torch.optim.Optimizer:
    """Build the four-group optimizer over ``model``'s parameters.

    ``kw`` are the optimizer's own arguments (``betas``, ``eps``,
    ``momentum``, ...); those it does not take, and ``None`` values, are
    dropped, as the JAX registry drops them.
    """
    cls = _optimizer_class(optimizer)
    accepted = set(inspect.signature(cls.__init__).parameters) - {"self", "params", "lr",
                                                                    "weight_decay"}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in kw.items() if k in accepted and v is not None}
    named = list(model.named_parameters())
    labels = param_group_labels([n for n, _ in named], lowest_level)
    settings = {"w_lo": (low_lr, weight_decay), "w_hi": (lr, weight_decay),
                "b_lo": (low_lr, bias_decay), "b_hi": (lr, bias_decay)}
    groups = []
    for label in GROUPS:
        params = [p for n, p in named if labels[n] == label]
        if params:
            g_lr, g_wd = settings[label]
            groups.append({"params": params, "name": label, "lr": g_lr, "weight_decay": g_wd})
    return cls(groups, **kw)


def multistep_lr(base_lr: float, epoch: int, milestones: Sequence[int], gamma: float = 0.1) -> float:
    """torch ``MultiStepLR``: ``base_lr * gamma ** (number of milestones <= epoch)``.

    Negative milestones are kept: the default ``[-1]`` applies gamma from the first epoch.
    """
    return base_lr * (gamma ** bisect.bisect_right(sorted(milestones), epoch))


def _sched_MultiStepLR(base_lr, epoch, milestones=(-1,), gamma=0.1):
    return multistep_lr(base_lr, epoch, list(milestones), gamma)


def _sched_StepLR(base_lr, epoch, step_size=30, gamma=0.1):
    return base_lr * (gamma ** (epoch // step_size))


def _sched_ExponentialLR(base_lr, epoch, gamma=0.95):
    return base_lr * (gamma ** epoch)


def _sched_CosineAnnealingLR(base_lr, epoch, T_max=50, eta_min=0.0):
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / T_max)) / 2


def _sched_ConstantLR(base_lr, epoch):
    del epoch
    return base_lr


SCHEDULERS = {
    "MultiStepLR": _sched_MultiStepLR,
    "StepLR": _sched_StepLR,
    "ExponentialLR": _sched_ExponentialLR,
    "CosineAnnealingLR": _sched_CosineAnnealingLR,
    "ConstantLR": _sched_ConstantLR,
    "None": _sched_ConstantLR,
}


def schedule_lr(name: str, base_lr: float, epoch: int, **kw) -> float:
    """Scheduler ``name`` at ``epoch``; keyword arguments it does not take are dropped."""
    fn = SCHEDULERS[name]
    accepted = set(inspect.signature(fn).parameters) - {"base_lr", "epoch"}
    kw = {k: v for k, v in kw.items() if k in accepted and v is not None}
    return fn(base_lr, epoch, **kw)


def set_group_lrs(optimizer: torch.optim.Optimizer, lrs: Dict[str, float]) -> None:
    """Set the ``lr`` of each labelled group named in ``lrs``, in place."""
    for group in optimizer.param_groups:
        if group["name"] in lrs:
            group["lr"] = lrs[group["name"]]
