"""The port's trainer command line and its train step with the on-device augmentation.

``build_parser`` must have the JAX CLI's flags (option strings, destinations,
defaults, nargs and choices). ``make_train_step(pipeline=...)`` must equal
the step without a pipeline on the batch the port's ``apply_pipeline`` gives
for the same seed (bit for bit: the same ops in the same order on the CPU).
``main([... "--cpu"])`` trains piv v1 for one epoch on a 4-pair 64x64
dataset from ``make_dataset_dir`` (crop 64, batch 2), then ``--resume`` from
its checkpoint: the resumed epoch's losses must equal an unbroken run's bit
for bit (the CPU path is deterministic, and the batch order and the draws
derive from the seed, the epoch and the batch index). Whole models run here,
so torch uses one thread.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch import piv_liteflownet
from piv_liteflownet_tpu_torch.data.datasets import get_transform
from piv_liteflownet_tpu_torch.data.piv_gen import make_dataset_dir
from piv_liteflownet_tpu_torch.data.transforms import apply_pipeline
from piv_liteflownet_tpu_torch.models.convert import to_jax_params
from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_train_step
from piv_liteflownet_tpu_torch.trainer import build_parser, main, step_seed
from piv_liteflownet_tpu_torch.training.loss import piv_loss
from piv_liteflownet_tpu_torch.training.optim import make_optimizer
from piv_liteflownet_tpu_torch.utils import config as cfgutil
from piv_liteflownet_tpu_torch.utils.timer import IteratorTimer, TimerBlock


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; these tests use one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _actions(parser):
    return [(a.option_strings, a.dest, a.default, a.nargs, a.choices) for a in parser._actions]


def test_build_parser_has_the_jax_flags():
    import trainer as jtrainer

    assert _actions(build_parser()) == _actions(jtrainer.build_parser())


def test_reflected_groups_build_as_jax():
    import trainer as jtrainer

    from piv_liteflownet_tpu.utils import config as jcfg

    argv = ["--model", "LiteFlowNet2", "--model_lowest_level", "3", "--loss", "LevelLoss",
            "--loss_n_level", "4", "--optimizer", "SGD", "--optimizer_momentum", "0.9",
            "--lr_scheduler", "StepLR", "--lr_scheduler_step_size", "4"]
    ours, theirs = build_parser(), jtrainer.build_parser()
    a, b = ours.parse_args(argv), theirs.parse_args(argv)
    assert vars(a) == vars(b)
    for group in ("optimizer", "lr_scheduler", "loss", "model"):
        assert cfgutil.kwargs_from_args(a, group) == jcfg.kwargs_from_args(b, group)
    cfg, jcfg_ = cfgutil.instance_from_args(ours, a, "model"), jcfg.instance_from_args(theirs, b, "model")
    assert (cfg.version, cfg.lowest_level, cfg.rgb_mean) == (jcfg_.version, jcfg_.lowest_level, jcfg_.rgb_mean)
    loss, jloss = cfgutil.instance_from_args(ours, a, "loss"), jcfg.instance_from_args(theirs, b, "loss")
    assert type(loss).__name__ == type(jloss).__name__ and loss.n_level == jloss.n_level == 4


def test_timer_helpers(capsys):
    with TimerBlock("phase") as block:
        block.log("inside")
    out = capsys.readouterr().out
    assert "phase" in out and "inside" in out and "Finished" in out
    it = IteratorTimer([1, 2])
    assert list(it) == [1, 2] and len(it) == 2 and it.last_duration >= 0


def test_step_seed_is_the_jax_trainers():
    assert step_seed(1, 3, 2) == 1 * 100003 + 3 * 1009 + 2


def _batch(b=2, h=72, w=104, seed=0):
    rng = np.random.default_rng(seed)
    img1 = rng.random((b, h, w, 3), dtype=np.float32)
    img2 = np.clip(img1 + 0.05 * rng.standard_normal((b, h, w, 3), dtype=np.float32), 0, 1)
    return img1, img2, (2.0 * rng.standard_normal((b, h, w, 2))).astype(np.float32)


def test_train_step_with_pipeline_equals_the_step_on_the_augmented_batch():
    pipe = get_transform(crop_size=(64, 96), mode="train")
    img1, img2, target = _batch()

    def built(pipeline):
        model = piv_liteflownet(seed=3, device="cpu")
        opt = make_optimizer(model, model.cfg.lowest_level)
        return TrainState(model, opt), make_train_step(model.cfg, piv_loss(), opt, pipeline=pipeline)

    state, step = built(pipe)
    with pytest.raises(ValueError, match="rng"):
        step(state, img1, img2, target)
    state, metrics = step(state, img1, img2, target, 17)
    aug = apply_pipeline(17, *(torch.from_numpy(a) for a in (img1, img2, target)), pipe)
    assert aug[0].shape == (2, 64, 96, 3)
    plain_state, plain_step = built(None)
    plain_state, plain_metrics = plain_step(plain_state, *aug)
    assert torch.equal(metrics["loss"], plain_metrics["loss"])
    for (n, p), q in zip(state.model.named_parameters(), plain_state.model.parameters()):
        assert torch.equal(p, q), n


def _losses(trainer, key="train_batch"):
    """(epoch, loss) of every batch of ``key`` the run logged."""
    rows = [json.loads(line) for line in (Path(trainer.experiment.dir) / "metrics.jsonl").read_text().splitlines()]
    return [(r["epoch"], r["value"]) for r in rows if r.get("metric", "").startswith(key)]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("piv")
    make_dataset_dir(str(root), n=4, size=(64, 64), seed=5, device="cpu")
    return root


def _argv(dataset, out, *extra):
    return ["--cpu", "--training_dataset_root", str(dataset), "--validation_dataset_root", str(dataset),
            "--batch_size", "2", "--crop_size", "64", "64", "--number_workers", "2",
            "--save", str(out), "--logger_workdir", str(out / "exp"), *extra]


def test_main_trains_on_the_cpu_and_resumes_as_an_unbroken_run(dataset, tmp_path):
    first = main(_argv(dataset, tmp_path / "a", "--total_epochs", "1", "--backup_frequency", "1"))
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    for want in ("LiteFlowNet_checkpoint", "LiteFlowNet_model_best", "backup_1", "args.txt"):
        assert want in names
    args_txt = (tmp_path / "a" / "args.txt").read_text()
    assert "model: LiteFlowNet\n" in args_txt and "start_epoch: 1\n" in args_txt
    # 3 train pairs, batch 2, drop_last: one step, its host wait logged, no step time off the card
    assert [e for e, _ in _losses(first, "train_wait_ms")] == [1] and not _losses(first, "train_step_ms")
    resumed = main(_argv(dataset, tmp_path / "b", "--total_epochs", "2",
                         "--resume", str(tmp_path / "a" / "backup_1")))
    assert "start_epoch: 2\n" in (tmp_path / "b" / "args.txt").read_text()
    unbroken = main(_argv(dataset, tmp_path / "u", "--total_epochs", "2"))
    u_train, u_val = _losses(unbroken), _losses(unbroken, "val_batch")
    assert [e for e, _ in u_train] == [1, 2] and all(np.isfinite(v) for _, v in u_train + u_val)
    assert _losses(first) == u_train[:1] and _losses(first, "val_batch") == u_val[:1]
    assert _losses(resumed) == u_train[1:] and _losses(resumed, "val_batch") == u_val[1:]
    for a, b in zip(resumed.state.model.parameters(), unbroken.state.model.parameters()):
        assert torch.equal(a, b)


def test_main_loads_pretrained_weights(dataset, tmp_path):
    from piv_liteflownet_tpu_torch.models.factory import PIV_V1
    from piv_liteflownet_tpu_torch.utils.checkpoint import save_params_npz

    want = piv_liteflownet(seed=9, device="cpu").state_dict()
    save_params_npz(PIV_V1, want, str(tmp_path / "w.npz"))
    torch.save(want, str(tmp_path / "w.paramOnly"))
    for path in ("w.npz", "w.paramOnly"):
        trainer = main(_argv(dataset, tmp_path / path.split(".")[1], "--total_epochs", "0",
                             "--model_rgb_mean", *map(str, PIV_V1.rgb_mean), "--pretrained", str(tmp_path / path)))
        got = trainer.state.model.state_dict()
        assert trainer.state.model.cfg == PIV_V1 and all(torch.equal(got[k], want[k]) for k in want)
    assert to_jax_params(PIV_V1, want).keys() == set(np.load(str(tmp_path / "w.npz")).files)


@pytest.mark.parametrize("flags", [["--number_devices", "2", "--batch_size", "3", "--total_epochs", "1"]])
def test_main_raises_for_what_is_not_ported(dataset, tmp_path, flags):
    """Data-parallel training is ported (tests/test_torch_parallel.py); what raises is a batch
    that does not split over the ranks (3 over 2 here), as JAX's sharded device_put does."""
    with pytest.raises(RuntimeError, match="does not split over 2 ranks"):
        main(_argv(dataset, tmp_path, "--total_epochs", "0", *flags))


@pytest.mark.parametrize("name,flags,want", [
    ("Yogi", ["--optimizer_betas", "0.8", "0.95", "--optimizer_eps", "1e-4"], {"betas": (0.8, 0.95), "eps": 1e-4}),
    ("Lion", ["--optimizer_betas", "0.85", "0.9"], {"betas": (0.85, 0.9)}),
    ("Novograd", ["--optimizer_eps", "1e-6"], {"betas": (0.9, 0.25), "eps": 1e-6}),
    ("Lamb", ["--optimizer_betas", "0.7", "0.9", "--optimizer_eps", "1e-5"], {"betas": (0.7, 0.9), "eps": 1e-5}),
])
def test_main_builds_the_ports_own_optimizers(dataset, tmp_path, name, flags, want):
    trainer = main(_argv(dataset, tmp_path, "--total_epochs", "0", "--optimizer", name, *flags))
    opt = trainer.state.optimizer
    assert type(opt).__name__ == name
    for key, value in want.items():
        assert opt.defaults[key] == value and all(g[key] == value for g in opt.param_groups)
    assert {g["name"]: g["weight_decay"] for g in opt.param_groups} == {
        "w_lo": 4e-4, "w_hi": 4e-4, "b_lo": 0.0, "b_hi": 0.0}


@pytest.mark.parametrize("name", ["Novograd", "Yogi"])
def test_main_resumes_the_ports_own_optimizers_as_an_unbroken_run(dataset, tmp_path, name):
    """Their step counts and moments go through the checkpoint: a resumed Novograd does not
    take its first-step branch again, a resumed Yogi keeps its bias correction's count."""
    flags = ("--optimizer", name, "--backup_frequency", "1")
    main(_argv(dataset, tmp_path / "a", "--total_epochs", "1", *flags))
    resumed = main(_argv(dataset, tmp_path / "b", "--total_epochs", "2", *flags,
                         "--resume", str(tmp_path / "a" / "backup_1")))
    unbroken = main(_argv(dataset, tmp_path / "u", "--total_epochs", "2", *flags))
    assert _losses(resumed) == _losses(unbroken)[1:]
    for a, b in zip(resumed.state.model.parameters(), unbroken.state.model.parameters()):
        assert torch.equal(a, b)
    for st in resumed.state.optimizer.state.values():
        assert float(st["count"]) == 2.0
