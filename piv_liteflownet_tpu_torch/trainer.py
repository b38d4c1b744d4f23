"""The trainer: its command line, the epoch loop, checkpoints and the lr schedule.

Port of the top-level ``trainer.py`` (the JAX package's CLI): ``build_parser`` has its flags, including the groups reflected from
signatures (``--model_*``, ``--loss_*``, ``--optimizer_*``,
``--lr_scheduler_*``, ``--training_dataset_*``, ``--validation_dataset_*``,
``--logger_*``), and ``main`` builds the model, the datasets and loaders,
the optimizer, the loss and the train step with the default augmentation on
the device, then runs ``Train``::

    python -m piv_liteflownet_tpu_torch.trainer --training_dataset_root DIR \
        --validation_dataset_root DIR --save OUT [--bf16] [--cpu]

``DIR`` holds ``train.json``/``val.json`` manifests of ``*_img1/_img2`` +
``_flow.flo`` triplets (``data/piv_gen.py:make_dataset_dir`` writes one). It
runs on the CUDA card unless ``--cpu`` is given. ``--native_io`` decodes the
training triplets with libpivio's C threads (``data/native.py``) where its
decoders take the dataset's formats, and raises if the library cannot be
built. ``--optimizer`` takes every name of the JAX registry: ``torch.optim``'s
and the port's own Lion, Lamb, Yogi and Novograd (``training/optim.py``).

``--number_devices N`` trains data-parallel over N ranks, one process a device
(``parallel/mesh.py:spawn``; -1: every CUDA device, or one rank with
``--cpu``; N is clamped to the devices present and printed). Each rank runs
:func:`train_rank`. ``--batch_size`` is the global batch, as in JAX: rank r's
loaders yield rows ``[r B/N, (r+1) B/N)`` of each batch one loader would form
(the same shuffle and epochs) and decode only those, and its step averages the
gradients over the ranks (``parallel/train_step.py``). A batch that does not
split over the ranks raises ``ValueError``, as JAX's sharded ``device_put``
does. Checkpoints, ``args.txt``, the experiment's ``metrics.jsonl`` and the
printing come from rank 0 only; ``--resume`` loads on every rank.

``Train`` takes a dict of loaders keyed ``"train"`` and ``"val"``; each is
a sized iterable of numpy batches ``((im1, im2), target)`` with ``im
[B,H,W,3]`` in [0, 1] and ``target [B,H,W,2]``, which a ``PrefetchLoader``
moves onto the model's device. Validation batches are centre-cropped to a
multiple of 64. Each train step draws its augmentation from the seed
``seed * 100003 + epoch * 1009 + batch index``, so a resumed run draws what
an unbroken one would. Loss values are read back from the device in blocks
of 16 batches, so the host does not wait on every step. Beside each train
batch's loss ``Train`` logs the host's wait for the batch (``train_wait_ms``)
and, on the card, the step's time between CUDA events around it
(``train_step_ms``) and the stream's time between the previous step's end
and this step's start (``train_idle_ms``: where the card waited on the host,
the loader or a loss readback).

``args.bf16`` (``--bf16``) asks for mixed-precision steps. The step decides
the precision, so ``Train`` refuses a step whose ``compute_dtype`` is not
the one ``args.bf16`` names. Checkpoints hold the float32 master params
either way. Validation runs the float32 eval forward in both cases, as the
JAX trainer's does.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import sys
from typing import Any, Callable, Dict, Optional

import torch

from piv_liteflownet_tpu_torch.data.loader import PrefetchLoader
from piv_liteflownet_tpu_torch.parallel.mesh import Mesh, devices_to_use, spawn
from piv_liteflownet_tpu_torch.parallel.train_step import TrainState
from piv_liteflownet_tpu_torch.training.optim import schedule_lr, set_group_lrs
from piv_liteflownet_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from piv_liteflownet_tpu_torch.utils.timer import IteratorTimer

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
    seed: int = 1  # the augmentation's per-step seeds derive from it


def step_seed(seed: int, epoch: int, batch_idx: int) -> int:
    """The seed of a train step's augmentation draws, as the JAX trainer derives its key."""
    return seed * 100003 + epoch * 1009 + batch_idx


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


class NoLogger:
    """The logger of the ranks other than 0: it records and writes nothing."""

    dir = None

    def set_name(self, name: str) -> None:
        pass

    def get_key(self) -> str:
        return ""

    def log_parameters(self, params) -> None:
        pass

    def log_current_epoch(self, epoch: int) -> None:
        pass

    def log_metric(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class Train:
    """Epoch loop: train, periodic validation, best and backup checkpoints (written by rank 0
    of a mesh only; ``written`` lists the files this process wrote)."""

    def __init__(self, args: TrainArgs, logger, loaders: Dict[str, Any], state: TrainState,
                 train_step: Callable, eval_step: Callable, rank: int = 0):
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
        self.rank = rank
        self.written: list = []

    def _epoch(self, key_name: str, epoch: int) -> float:
        loader = self.loaders[key_name]
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        training = "train" in key_name
        device = next(self.state.model.parameters()).device
        cuda = device.type == "cuda"
        total, n = 0.0, 0
        pending = []  # (batch index, loss on the device, (start, end, previous end) CUDA events or None)

        def flush():
            nonlocal total, n
            for bi, dev_loss, events in pending:
                batch_loss = float(dev_loss)
                if batch_loss != batch_loss:
                    raise FloatingPointError(f"NaN loss in {key_name} epoch {epoch} batch {bi}")
                step = (epoch - 1) * len(loader) + bi + 1
                self.experiment.log_metric("_".join([key_name, "batch", self.loss_label]),
                                           batch_loss, step=step, epoch=epoch)
                if events is not None:
                    start, end, prev_end = events
                    end.synchronize()
                    self.experiment.log_metric(key_name + "_step_ms", start.elapsed_time(end),
                                               step=step, epoch=epoch)
                    if prev_end is not None:
                        self.experiment.log_metric(key_name + "_idle_ms", prev_end.elapsed_time(start),
                                                   step=step, epoch=epoch)
                total += batch_loss
                n += 1
            pending.clear()

        def host_batches():
            for (im1, im2), target in loader:
                yield ((im1, im2), target) if training else _center_crop64(im1, im2, target)

        batches = IteratorTimer(PrefetchLoader(host_batches(), device, fence=getattr(loader, "fence", None)))
        prev_end = None
        for batch_idx, batch in enumerate(batches):
            events = None
            if training:
                self.experiment.log_metric(key_name + "_wait_ms", batches.last_duration * 1e3,
                                           step=(epoch - 1) * len(loader) + batch_idx + 1, epoch=epoch)
                (im1, im2), target = batch
                seed = step_seed(self.args.seed, epoch, batch_idx)
                if cuda:
                    events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), prev_end)
                    events[0].record()
                self.state, metrics = self.train_step(self.state, im1, im2, target, seed)
                if cuda:
                    events[1].record()
                    prev_end = events[1]
            else:
                metrics = self.eval_step(self.state.model, *batch)
            pending.append((batch_idx, metrics["loss"], events))
            if len(pending) >= FLUSH_EVERY:
                flush()
        flush()
        return total / max(n, 1)

    def save_model(self, epoch: int, best_err: float, is_best: bool,
                   filename: Optional[str] = None) -> Optional[str]:
        if self.rank != 0:
            return None
        state = {"model": self.state.model.state_dict(),
                 "optimizer": self.state.optimizer.state_dict(),
                 "epoch": int(epoch), "best_epe": float(best_err), "step": int(self.state.step)}
        meta = {"arch": self.args.model, "opt": self.args.optimizer,
                "exp_key": self.experiment.get_key(), "epoch": int(epoch),
                "best_EPE": float(best_err)}
        path = save_checkpoint(state, is_best, self.args.save, self.args.model,
                               filename=filename, metadata=meta)
        self.written.append(path)
        return path

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


def build_parser() -> argparse.ArgumentParser:
    """The JAX trainer's flags, with the port's registries behind the reflected groups."""
    from piv_liteflownet_tpu_torch.data import datasets as dsets
    from piv_liteflownet_tpu_torch.models.factory import HUI_MEAN, model_config_registry
    from piv_liteflownet_tpu_torch.training import loss as loss_mod
    from piv_liteflownet_tpu_torch.training import optim as optim_mod
    from piv_liteflownet_tpu_torch.utils import config as cfgutil
    from piv_liteflownet_tpu_torch.utils import metrics as metrics_mod

    parser = argparse.ArgumentParser(description="Training script for PIV-LiteFlowNet on a CUDA card")
    parser.add_argument("--start_epoch", type=int, default=1)
    parser.add_argument("--total_epochs", type=int, default=10000, help="Maximum epoch value")
    parser.add_argument("--batch_size", "-b", type=int, default=8, help="Batch size")
    parser.add_argument("--crop_size", type=int, nargs="+", default=[256, 256],
                        help="Spatial crop for training samples")
    parser.add_argument("--rgb_max", type=float, default=255.0)
    parser.add_argument("--weight_decay", "-wd", type=float, default=4e-4)
    parser.add_argument("--bias_decay", "-bd", type=float, default=0.0)
    parser.add_argument("--number_workers", "-nw", "--num_workers", type=int, default=8)
    parser.add_argument("--native_io", action="store_true",
                        help="decode training triplets with libpivio's C threads (PIVData of "
                             "PNG/TIFF/PNM frames); raises if the library cannot be built")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 compute with float32 master params, loss and optimizer")
    parser.add_argument("--number_devices", "-nd", type=int, default=-1,
                        help="ranks to train data-parallel over, one a CUDA card (-1: every card; "
                             "one rank with --cpu)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--name", default="run", type=str)
    parser.add_argument("--save", "-s", default="./work", type=str)
    parser.add_argument("--validation_frequency", type=int, default=1)
    parser.add_argument("--backup_frequency", type=int, default=25)
    parser.add_argument("--inference_size", type=int, nargs="+", default=[-1, -1])
    parser.add_argument("--pretrained", default="", type=str, metavar="PATH",
                        help="path to pre-trained weights (.paramOnly or .npz)")
    parser.add_argument("--resume", default="", type=str, metavar="PATH",
                        help="path to a checkpoint to resume from")

    cfgutil.add_arguments_for_module(
        parser, model_config_registry(), "model", default="LiteFlowNet",
        parameter_defaults={"starting_scale": 10.0, "lowest_level": 1, "rgb_mean": list(HUI_MEAN)})
    cfgutil.add_arguments_for_module(
        parser, {"MultiScale": loss_mod.MultiScale, "LevelLoss": loss_mod.LevelLoss,
                 "L1Loss": loss_mod.L1Loss, "L2Loss": loss_mod.L2Loss},
        "loss", default="MultiScale",
        parameter_defaults={"div_scale": 0.2, "startScale": 1,
                            "l_weight": [0.001, 0.001, 0.001, 0.001, 0.001, 0.01], "norm": "L2"})
    cfgutil.add_arguments_for_module(parser, optim_mod.OPTIMIZER_ARGS, "optimizer", default="Adam")
    parser.add_argument("--optimizer_lr", type=float, default=1e-3)
    parser.add_argument("--optimizer_low_lr", type=float, default=6e-5,
                        help="fixed lr for NetE levels < 4")
    cfgutil.add_arguments_for_module(
        parser, optim_mod.SCHEDULERS, "lr_scheduler", default="MultiStepLR",
        skip_params=["base_lr", "epoch"], parameter_defaults={"milestones": [-1], "gamma": 0.1})
    dataset_registry = {"PIVData": dsets.PIVData, "PIVH5": dsets.PIVH5, "PIVLMDB": dsets.PIVLMDB}
    for group, mode in (("training_dataset", "train"), ("validation_dataset", "val")):
        cfgutil.add_arguments_for_module(
            parser, dataset_registry, group, default="PIVData", skip_params=["is_cropped", "transform"],
            parameter_defaults={"root": "./data/piv_datasets", "mode": mode})
    cfgutil.add_arguments_for_module(
        parser, {"Experiment": metrics_mod.Experiment,
                 "ExistingExperiment": metrics_mod.ExistingExperiment}, "logger",
        default="Experiment",
        parameter_defaults={"project_name": "piv-flownet", "workdir": "./work/experiments"})
    return parser


def main(argv=None):
    """Parse ``argv``, build everything and train. In one process returns the finished
    ``Train``; over several ranks (``--number_devices``) spawns them and returns each rank's
    :func:`train_rank` summary, in rank order."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    n = devices_to_use(args.number_devices, args.cpu, "training")
    if n > 1:
        return spawn(train_rank, n, argv, devices=["cpu"] * n if args.cpu else None)
    return train(parser, args)


def train_rank(mesh: Mesh, argv) -> dict:
    """One rank of a data-parallel run of ``argv`` (the CLI's arguments) over ``mesh``: trains and
    returns ``{"rank", "written", "best_err", "step", "experiment_dir"}``. Ranks other than 0
    print nothing. ``chip_smoke.py`` spawns it with gloo, two ranks on one card."""
    parser = build_parser()
    args = parser.parse_args(list(argv))
    with contextlib.nullcontext() if mesh.rank == 0 else contextlib.redirect_stdout(io.StringIO()):
        trainer = train(parser, args, mesh)
    return {"rank": mesh.rank, "written": trainer.written, "best_err": trainer.args.best_err,
            "step": trainer.state.step, "experiment_dir": trainer.experiment.dir}


def train(parser: argparse.ArgumentParser, args, mesh: Optional[Mesh] = None) -> Train:
    """Build the model, data, optimizer, loss and steps of the parsed ``args`` and train, on the
    device of ``mesh``'s rank (data-parallel) or of ``--cpu``; returns the finished ``Train``."""
    from piv_liteflownet_tpu_torch.data.datasets import get_transform
    from piv_liteflownet_tpu_torch.data.loader import BatchLoader, native_train_loader_for
    from piv_liteflownet_tpu_torch.models.convert import load_param_only
    from piv_liteflownet_tpu_torch.models.factory import resolve_device
    from piv_liteflownet_tpu_torch.models.liteflownet import LiteFlowNet, ModelConfig
    from piv_liteflownet_tpu_torch.parallel.train_step import make_eval_step, make_train_step
    from piv_liteflownet_tpu_torch.training.optim import make_optimizer
    from piv_liteflownet_tpu_torch.utils import config as cfgutil
    from piv_liteflownet_tpu_torch.utils.checkpoint import load_params_npz
    from piv_liteflownet_tpu_torch.utils.timer import TimerBlock, log_arguments, set_proc_title

    device = mesh.device if mesh is not None else resolve_device("cpu" if args.cpu else None)
    rank, ranks = (mesh.rank, mesh.size) if mesh is not None else (0, 1)

    log_args = {k: v for k, v in sorted(vars(args).items()) if "logger" not in k}
    set_proc_title(f"piv_liteflownet_tpu_torch.trainer {args.name}")
    with TimerBlock("Parsing Arguments") as block:
        log_arguments(block, args, parser)

    with TimerBlock(f"Building {args.model} model") as block:
        cfg = cfgutil.instance_from_args(parser, args, "model")
        if not isinstance(cfg, ModelConfig):
            raise TypeError(f"--model {args.model} built {type(cfg).__name__}, not a ModelConfig")
        model = LiteFlowNet(cfg)
        model.init_parameters(torch.Generator().manual_seed(args.seed))
        if args.pretrained:
            state = (load_params_npz(cfg, args.pretrained) if args.pretrained.endswith(".npz")
                     else load_param_only(cfg, args.pretrained))
            model.load_state_dict(state, strict=True)
            block.log(f"Loaded pretrained weights from {args.pretrained}")
        model.to(device)
        block.log(f"Number of parameters: {sum(p.numel() for p in model.parameters())} on {device}")

    with TimerBlock("Initializing datasets") as block:
        train_ds = cfgutil.instance_from_args(parser, args, "training_dataset")
        train_loader = None
        if args.native_io:
            train_loader = native_train_loader_for(train_ds, batch_size=args.batch_size,
                                                   num_workers=args.number_workers, shuffle=True,
                                                   seed=args.seed, drop_last=True, rank=rank, ranks=ranks)
            block.log("native ingest: " + ("libpivio's C loader" if train_loader else
                                           "not for this dataset's formats; the Python loader"))
        if train_loader is None:
            train_loader = BatchLoader(train_ds, batch_size=args.batch_size, num_workers=args.number_workers,
                                       shuffle=True, seed=args.seed, drop_last=True, rank=rank, ranks=ranks)
        loaders = {"train": train_loader}
        try:
            val_ds = cfgutil.instance_from_args(parser, args, "validation_dataset")
            loaders["val"] = BatchLoader(val_ds, batch_size=args.batch_size,
                                         num_workers=args.number_workers, rank=rank, ranks=ranks)
        except FileNotFoundError:
            block.log("No validation dataset found: training without validation")
        block.log(f"train={len(train_ds)} samples")

    with TimerBlock("Initializing optimizer + train step") as block:
        opt_kwargs = cfgutil.kwargs_from_args(args, "optimizer", skip=("lr", "low_lr"))
        optimizer = make_optimizer(model, cfg.lowest_level, optimizer=args.optimizer,
                                   lr=args.optimizer_lr, low_lr=args.optimizer_low_lr,
                                   weight_decay=args.weight_decay, bias_decay=args.bias_decay,
                                   **opt_kwargs)
        loss_obj = cfgutil.instance_from_args(parser, args, "loss")
        pipeline = get_transform(crop_size=tuple(args.crop_size), mode="train")
        train_step = make_train_step(cfg, loss_obj, optimizer, mesh=mesh, pipeline=pipeline,
                                     compute_dtype=torch.bfloat16 if args.bf16 else None)
        eval_step = make_eval_step(cfg, loss_obj, mesh=mesh)
        state = TrainState(model, optimizer)
        block.log(f"{args.optimizer}, {type(loss_obj).__name__}, {'bf16' if args.bf16 else 'float32'} steps"
                  + (f", data-parallel over {ranks} ranks ({mesh.backend})" if mesh is not None else ""))

    with TimerBlock("Initializing logger") as block:
        logger = cfgutil.instance_from_args(parser, args, "logger") if rank == 0 else NoLogger()
        logger.set_name(args.name)
        logger.log_parameters(log_args)
        targs = TrainArgs(
            model=args.model, optimizer=args.optimizer, start_epoch=args.start_epoch,
            total_epochs=args.total_epochs, validation_frequency=args.validation_frequency,
            backup_frequency=args.backup_frequency, save=args.save, optimizer_lr=args.optimizer_lr,
            optimizer_low_lr=args.optimizer_low_lr, lr_scheduler=args.lr_scheduler,
            lr_scheduler_kwargs=cfgutil.kwargs_from_args(args, "lr_scheduler"),
            loss_norm=getattr(args, "loss_norm", "L2"), bf16=args.bf16, seed=args.seed)
        if args.resume:
            resume(state, args.resume, targs)
            block.log(f"Resumed from {args.resume} at epoch {targs.start_epoch}")
        args.start_epoch, args.best_err = targs.start_epoch, targs.best_err
        if rank == 0:
            os.makedirs(args.save, exist_ok=True)
            with open(os.path.join(args.save, "args.txt"), "w") as f:
                for k, v in sorted(vars(args).items()):
                    f.write(f"{k}: {v}\n")

    trainer = Train(targs, logger, loaders, state, train_step, eval_step, rank=rank)
    try:
        trainer()
    finally:
        logger.close()
    return trainer


if __name__ == "__main__":
    main()
