"""The optimizer with the four parameter groups of the reference, and the lr schedules.

Port of ``piv_liteflownet_tpu/training/optim.py``. The groups:

1. ``w_lo``: ``.weight`` of the NetE_{M,S,R} modules whose pyramid level is
   below 4 -> ``low_lr``, ``weight_decay``;
2. ``w_hi``: every other ``.weight`` -> ``lr``, ``weight_decay``;
3. ``b_lo``: ``.bias`` of NetE modules below level 4 -> ``low_lr``, ``bias_decay``;
4. ``b_hi``: every other ``.bias`` -> ``lr``, ``bias_decay``.

One ``torch.optim`` optimizer holds them, each group tagged with its label
under ``"name"``. Decay is torch's: L2 added to the gradient, or decoupled
for AdamW, Lion and Lamb, as the JAX package's ``_group`` sets it. Schedules
are pure functions ``epoch -> lr``; :func:`set_group_lrs` writes them into
the groups.

Lion, Lamb, Yogi and Novograd, which ``torch.optim`` lacks, are this
module's own :class:`torch.optim.Optimizer` subclasses, each the function of
the JAX package's group transform (``_group`` on optax 0.2.6's
``scale_by_lion``, ``scale_by_adam`` + ``scale_by_trust_ratio``,
``scale_by_yogi``, ``scale_by_novograd``), not of its paper or another
library. Their step count lives in each parameter's state as a float32
tensor on its device (``"count"``), and no value of theirs is read back to
the host.
"""

from __future__ import annotations

import bisect
import inspect
import math
from typing import Dict, Iterable, Sequence

import torch

GROUPS = ("w_lo", "w_hi", "b_lo", "b_hi")


class _Transform(torch.optim.Optimizer):
    """An optax transform of the JAX package's ``_group`` as a torch optimizer.

    Each group has its ``lr`` and ``weight_decay``. ``step`` hands a subclass's ``_update`` the
    parameters that have a gradient, their gradients and their states, all as lists, and the
    update runs on them with ``torch._foreach_*`` ops: a few launches a group, not a few a
    parameter. ``decoupled`` says where ``weight_decay * p`` goes: after the direction (Lion,
    Lamb: ``p -= lr * (direction + wd * p)``) or into the gradient before the moments (Yogi,
    Novograd).
    """

    decoupled = False

    def __init__(self, params, lr: float, weight_decay: float, **defaults):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, **defaults))

    def _new_state(self, p: torch.Tensor) -> dict:
        raise NotImplementedError

    def _update(self, group: dict, params: list, grads: list, states: list) -> list:
        """The direction of each parameter, before ``-lr`` (and before a decoupled decay); the
        caller does not write into it."""
        raise NotImplementedError

    @staticmethod
    def _counts(states: list) -> torch.Tensor:
        """Add one to every parameter's count; the counts as one vector."""
        counts = [s["count"] for s in states]
        torch._foreach_add_(counts, 1.0)
        return torch.stack(counts)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = []
            for p in params:
                if not self.state[p]:
                    self.state[p] = dict(count=torch.zeros((), dtype=torch.float32, device=p.device),
                                         **self._new_state(p))
                states.append(self.state[p])
            grads = [p.grad for p in params]
            wd = group["weight_decay"]
            if wd and not self.decoupled:
                grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
            direction = self._update(group, params, grads, states)
            if wd and self.decoupled:
                direction = torch._foreach_add(direction, torch._foreach_mul(params, wd))
            torch._foreach_add_(params, torch._foreach_mul(direction, -group["lr"]))
        return loss


def _ema_(moments: list, values: list, decay: float) -> None:
    """``m = (1 - decay) * value + decay * m`` in place (optax's ``update_moment``)."""
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, torch._foreach_mul(values, 1.0 - decay))


def _bias_corrected(moments: list, decay: float, counts: torch.Tensor) -> list:
    """``m / (1 - decay ** count)`` (optax's ``bias_correction``)."""
    return torch._foreach_div(moments, list((1.0 - decay ** counts).unbind()))


def _scaled_by_rms(mu_hat: list, nu_hat: list, eps: float) -> list:
    """``mu_hat / (sqrt(nu_hat) + eps)``."""
    denom = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(denom, eps)
    return torch._foreach_div(mu_hat, denom)


class Lion(_Transform):
    """optax ``scale_by_lion``: ``sign((1 - b1) g + b1 m)`` with the old ``m``, then ``m`` moves
    with ``b2``; decoupled decay."""

    decoupled = True

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay, betas=tuple(betas))

    def _new_state(self, p):
        return {"mu": torch.zeros_like(p)}

    def _update(self, group, params, grads, states):
        b1, b2 = group["betas"]
        mus = [s["mu"] for s in states]
        direction = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(direction, torch._foreach_mul(mus, b1))
        torch._foreach_sign_(direction)
        _ema_(mus, grads, b2)
        self._counts(states)
        return direction


class Lamb(_Transform):
    """optax ``scale_by_adam`` then ``scale_by_trust_ratio``: the Adam direction ``u`` times
    ``||p|| / ||u||`` per parameter tensor (1 where either norm is 0); decoupled decay, added
    after the ratio."""

    decoupled = True

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay, betas=tuple(betas), eps=eps)

    def _new_state(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _update(self, group, params, grads, states):
        b1, b2 = group["betas"]
        mus, nus = [s["mu"] for s in states], [s["nu"] for s in states]
        _ema_(mus, grads, b1)
        _ema_(nus, torch._foreach_mul(grads, grads), b2)
        counts = self._counts(states)
        u = _scaled_by_rms(_bias_corrected(mus, b1, counts), _bias_corrected(nus, b2, counts),
                           group["eps"])
        p_norm = torch.stack(torch._foreach_norm(params))
        u_norm = torch.stack(torch._foreach_norm(u))
        ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
        torch._foreach_mul_(u, list(ratio.unbind()))
        return u


class Yogi(_Transform):
    """optax ``scale_by_yogi``: both moments start at 1e-6 (``initial_accumulator_value``),
    ``nu -= (1 - b2) * sign(nu - g^2) * g^2``, both bias-corrected; L2 decay in the gradient."""

    INITIAL = 1e-6

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-3,
                 weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay, betas=tuple(betas), eps=eps)

    def _new_state(self, p):
        return {"mu": torch.full_like(p, self.INITIAL), "nu": torch.full_like(p, self.INITIAL)}

    def _update(self, group, params, grads, states):
        b1, b2 = group["betas"]
        mus, nus = [s["mu"] for s in states], [s["nu"] for s in states]
        _ema_(mus, grads, b1)
        g2 = torch._foreach_mul(grads, grads)
        step = torch._foreach_sub(nus, g2)
        torch._foreach_sign_(step)
        torch._foreach_mul_(step, 1.0 - b2)
        torch._foreach_mul_(step, g2)
        torch._foreach_sub_(nus, step)
        counts = self._counts(states)
        return _scaled_by_rms(_bias_corrected(mus, b1, counts), _bias_corrected(nus, b2, counts),
                              group["eps"])


class Novograd(_Transform):
    """optax ``scale_by_novograd``: a scalar ``nu`` per tensor, the moving ``||g||^2``, set to
    ``||g||^2`` on the first step (``count == 1``, by ``torch.where`` on the device);
    ``mu = b1 * mu + g / (sqrt(nu) + eps)``; no bias correction; L2 decay in the gradient."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.25), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay, betas=tuple(betas), eps=eps)

    def _new_state(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros((), dtype=p.dtype, device=p.device)}

    def _update(self, group, params, grads, states):
        b1, b2 = group["betas"]
        mus, nus = [s["mu"] for s in states], [s["nu"] for s in states]
        first = self._counts(states) == 1
        g_sq = torch.stack(torch._foreach_norm(grads)) ** 2
        nu = torch.where(first, g_sq, (1.0 - b2) * g_sq + b2 * torch.stack(nus))
        torch._foreach_copy_(nus, list(nu.unbind()))
        denom = torch.sqrt(nu) + group["eps"]
        scaled = torch._foreach_div(grads, list(denom.unbind()))
        # optax sets mu to ``scaled`` on the first step; mu is still zero then, so
        # ``b1 * mu + scaled`` is that value
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, scaled)
        return mus


#: The JAX package's registry, by name: ``torch.optim``'s classes and this module's own.
OPTIMIZERS = {name: getattr(torch.optim, name) for name in (
    "Adam", "AdamW", "SGD", "RMSprop", "Adagrad", "Adadelta", "Adamax", "NAdam", "RAdam")}
OPTIMIZERS.update(Lion=Lion, Lamb=Lamb, Yogi=Yogi, Novograd=Novograd)
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
