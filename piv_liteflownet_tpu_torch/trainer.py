"""The training epoch loop: train and validation epochs, checkpoints, lr schedule.

Port of the ``Train`` class of the top-level ``trainer.py`` (:124-258) and of
its resume path, for one device. ``Train`` takes a dict of loaders keyed
``"train"`` and ``"val"``; each is a sized iterable of numpy batches
``((im1, im2), target)`` with ``im [B,H,W,3]`` in [0, 1] and ``target
[B,H,W,2]``. Validation batches are centre-cropped to a multiple of 64.
Loss values are read back from the device in blocks of 16 batches, so the
host does not wait on every step.

The command line with its dataset flags waits for the data slice of the
port (ROADMAP.md, Queue 1 item 6); until then a caller builds the model,
optimizer, steps and loaders itself, as ``chip_smoke.py`` does::

    args = TrainArgs(total_epochs=2)
    model = piv_liteflownet(seed=1)
    optimizer = make_optimizer(model, model.cfg.lowest_level)
    loss = piv_loss()
    state = TrainState(model, optimizer)
    step = make_train_step(model.cfg, loss, optimizer,
                           compute_dtype=torch.bfloat16 if args.bf16 else None)
    Train(args, Experiment(), {"train": batches}, state, step, make_eval_step(model.cfg, loss))()

``args.bf16`` (the top-level trainer's ``--bf16``) asks for mixed-precision
steps. The step decides the precision, so ``Train`` refuses a step whose
``compute_dtype`` is not the one ``args.bf16`` names. Checkpoints hold the
float32 master params either way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from piv_liteflownet_tpu_torch.parallel.train_step import TrainState
from piv_liteflownet_tpu_torch.training.optim import schedule_lr, set_group_lrs
from piv_liteflownet_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

FLUSH_EVERY = 16  # batches between loss readbacks


@dataclasses.dataclass
class TrainArgs:
    """The settings the loop reads; names as the top-level trainer's flags."""

    model: str = "LiteFlowNet"  # checkpoint prefix
    optimizer: str = "Adam"
    start_epoch: int = 1
    total_epochs: int = 10000
    validation_frequency: int = 1
    backup_frequency: int = 25
    save: str = "./work"
    optimizer_lr: float = 1e-3
    optimizer_low_lr: float = 6e-5
    lr_scheduler: str = "MultiStepLR"
    lr_scheduler_kwargs: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"milestones": [-1], "gamma": 0.1})
    loss_norm: str = "L2"
    best_err: float = 1e8
    bf16: bool = False  # the train step's compute_dtype is bf16 (Train checks it); float32 masters


def set_epoch_lrs(optimizer: torch.optim.Optimizer, args: TrainArgs, epoch: int) -> Optional[float]:
    """Set the groups' lrs to the schedule's value at ``epoch``; returns the high lr, or None
    when the schedule is constant."""
    if args.lr_scheduler in ("None", "ConstantLR"):
        return None
    lr = schedule_lr(args.lr_scheduler, args.optimizer_lr, epoch, **args.lr_scheduler_kwargs)
    low = schedule_lr(args.lr_scheduler, args.optimizer_low_lr, epoch, **args.lr_scheduler_kwargs)
    set_group_lrs(optimizer, {"w_hi": lr, "b_hi": lr, "w_lo": low, "b_lo": low})
    return lr


def resume(state: TrainState, path: str, args: TrainArgs) -> None:
    """Load the checkpoint ``path`` into ``state`` and move ``args`` to the epoch after it.

    The schedule's lrs of the checkpoint's epoch are set again: the loop
    steps the schedule after it writes the validation checkpoint.
    """
    device = next(state.model.parameters()).device
    ckpt = restore_checkpoint(path, map_location=device)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    args.start_epoch = int(ckpt["epoch"]) + 1
    args.best_err = float(ckpt["best_epe"])
    set_epoch_lrs(state.optimizer, args, args.start_epoch - 1)


def _center_crop64(im1, im2, target):
    h, w = im1.shape[1] // 64 * 64, im1.shape[2] // 64 * 64
    t0, l0 = (im1.shape[1] - h) // 2, (im1.shape[2] - w) // 2
    return tuple(a[:, t0:t0 + h, l0:l0 + w] for a in (im1, im2, target))


class Train:
    """Epoch loop: train, periodic validation, best and backup checkpoints."""

    def __init__(self, args: TrainArgs, logger, loaders: Dict[str, Any], state: TrainState,
                 train_step: Callable, eval_step: Callable):
        want = torch.bfloat16 if args.bf16 else torch.float32
        got = getattr(train_step, "compute_dtype", None)
        if got != want:
            raise ValueError(f"args.bf16={args.bf16} asks for {want} steps, the train step computes in "
                             f"{got}: build it with make_train_step(..., compute_dtype={want})")
        self.args = args
        self.experiment = logger
        self.loaders = loaders
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.loss_label = "MultiScale-" + args.loss_norm

    def _epoch(self, key_name: str, epoch: int) -> float:
        loader = self.loaders[key_name]
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        training = "train" in key_name
        total, n = 0.0, 0
        pending = []  # (batch index, loss on the device)

        def flush():
            nonlocal total, n
            for bi, dev_loss in pending:
                batch_loss = float(dev_loss)
                if batch_loss != batch_loss:
                    raise FloatingPointError(f"NaN loss in {key_name} epoch {epoch} batch {bi}")
                self.experiment.log_metric("_".join([key_name, "batch", self.loss_label]),
                                           batch_loss, step=(epoch - 1) * len(loader) + bi + 1,
                                           epoch=epoch)
                total += batch_loss
                n += 1
            pending.clear()

        for batch_idx, ((im1, im2), target) in enumerate(loader):
            if training:
                self.state, metrics = self.train_step(self.state, im1, im2, target)
            else:
                im1, im2, target = _center_crop64(im1, im2, target)
                metrics = self.eval_step(self.state.model, im1, im2, target)
            pending.append((batch_idx, metrics["loss"]))
            if len(pending) >= FLUSH_EVERY:
                flush()
        flush()
        return total / max(n, 1)

    def save_model(self, epoch: int, best_err: float, is_best: bool,
                   filename: Optional[str] = None) -> str:
        state = {"model": self.state.model.state_dict(),
                 "optimizer": self.state.optimizer.state_dict(),
                 "epoch": int(epoch), "best_epe": float(best_err), "step": int(self.state.step)}
        meta = {"arch": self.args.model, "opt": self.args.optimizer,
                "exp_key": self.experiment.get_key(), "epoch": int(epoch),
                "best_EPE": float(best_err)}
        return save_checkpoint(state, is_best, self.args.save, self.args.model,
                               filename=filename, metadata=meta)

    def __call__(self) -> None:
        args = self.args
        best_err = args.best_err
        best_epoch = args.start_epoch
        for epoch in range(args.start_epoch, args.total_epochs + 1):
            self.experiment.log_current_epoch(epoch)
            for key in self.loaders:
                if "train" in key:
                    loss_val = self._epoch(key, epoch)
                elif "val" in key and (epoch - 1) % args.validation_frequency == 0:
                    loss_val = self._epoch(key, epoch)
                    is_best = loss_val < best_err
                    if is_best:
                        best_err, best_epoch = loss_val, epoch
                    self.save_model(epoch, best_err, is_best)
                else:
                    continue
                self.experiment.log_metric("_".join([key, self.loss_label]), loss_val,
                                           step=epoch, epoch=epoch)
                self.experiment.log_metric("best_epoch", best_epoch)
            lr = set_epoch_lrs(self.state.optimizer, args, epoch)
            if lr is not None:
                self.experiment.log_metric("current_lr", lr, step=epoch, epoch=epoch)
            if (epoch - 1) % args.backup_frequency == 0:
                self.save_model(epoch, best_err, False, filename=f"backup_{epoch}")
        args.best_err = best_err
