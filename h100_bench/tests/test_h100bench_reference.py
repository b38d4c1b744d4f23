"""The plain reference against the program's plain path (``PLAIN_OPS``) on the CPU, at small
sizes, for both versions: the npz conversion, the eval and train forward, the augmentation and
the whole training step."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench.reference import model as ref_model
from h100_bench.reference import train as ref_train
from h100_bench.reference import weights

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {1: "piv-lfn-en-v1-f32", 2: "piv-lfn2-en-v2-bf16"}


def config(version):
    return json.loads((ROOT / "h100_bench" / "configs" / f"{CONFIGS[version]}.json").read_text())


def port_model(version):
    from piv_liteflownet_tpu_torch.models.liteflownet import LiteFlowNet, ModelConfig
    from piv_liteflownet_tpu_torch.utils.checkpoint import load_params_npz

    m = config(version)["model"]
    cfg = ModelConfig(version=m["version"], starting_scale=m["starting_scale"], lowest_level=m["lowest_level"],
                      rgb_mean=tuple(m["rgb_mean"]))
    net = LiteFlowNet(cfg)
    net.load_state_dict(load_params_npz(cfg, str(ROOT / config(version)["weights"])), strict=True)
    return net.eval()


def ref_net(version):
    c = config(version)
    return ref_model.Net(weights.load_npz(str(ROOT / c["weights"])), c["model"])


def frames(b, h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    im1 = torch.rand((b, h, w, 3), generator=g)
    return im1, torch.roll(im1, (2, -1), (1, 2)) * 0.9 + 0.05


@pytest.mark.parametrize("version", [1, 2])
def test_weights_match_the_programs_conversion(version):
    c = config(version)
    ours = weights.load_npz(str(ROOT / c["weights"]))
    theirs = port_model(version).state_dict()
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert torch.equal(ours[k], v), k


@pytest.mark.parametrize("version", [1, 2])
def test_eval_forward_matches_plain_path(version, few_threads):
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS

    im1, im2 = frames(2, 80, 112)  # not multiples of 32: both resizes run
    got = estimate(port_model(version), im1, im2, tensor=True, ops=PLAIN_OPS)
    want = ref_model.estimate(ref_net(version), im1, im2)
    assert got.shape == want.shape == (2, 80, 112, 2)
    assert float((got - want).abs().max()) < 1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("version", [1, 2])
def test_train_forward_matches_plain_path(version, few_threads):
    from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS

    im1, im2 = frames(2, 64, 64, seed=1)
    x1, x2 = im1.permute(0, 3, 1, 2).contiguous(), im2.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = port_model(version)(x1, x2, PLAIN_OPS, train=True)
        want = ref_net(version).forward(x1, x2, train=True)
    assert len(got) == len(want) == 6
    for la, lb in zip(got, want):
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            assert float((a - b).abs().max()) < 1e-4 * max(1.0, float(b.abs().max()))


def test_augmentation_matches_the_programs_pipeline():
    from piv_liteflownet_tpu_torch.data.datasets import get_transform
    from piv_liteflownet_tpu_torch.data.transforms import apply_pipeline

    g = torch.Generator().manual_seed(3)
    im1, im2 = torch.rand((4, 96, 80, 3), generator=g), torch.rand((4, 96, 80, 3), generator=g)
    flow = torch.randn((4, 96, 80, 2), generator=g) * 3
    for seed in (0, 12345, 2 ** 40 + 7):
        got = apply_pipeline(seed, im1, im2, flow, get_transform(crop_size=(64, 48), mode="train"))
        want = ref_train.augment(im1, im2, flow, seed, (64, 48))
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) < 1e-4


def test_training_steps_match_the_programs_step(few_threads):
    """Three steps of the program's float32 step (plain ops, its pipeline, its Adam) and of
    the reference give the same losses, first gradients and changes."""
    from piv_liteflownet_tpu_torch.data.datasets import get_transform
    from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS
    from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_train_step
    from piv_liteflownet_tpu_torch.training import loss, optim

    c = config(1)
    o = c["optim"]
    model = port_model(1).train()
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = optim.make_optimizer(model, 1, lr=o["lr_hi"], low_lr=o["lr_lo"], weight_decay=o["weight_decay"],
                               bias_decay=o["bias_decay"], betas=tuple(o["betas"]), eps=o["eps"])
    step = make_train_step(model.cfg, loss.piv_loss(version=1), opt, ops=PLAIN_OPS,
                           pipeline=get_transform(crop_size=(64, 64), mode="train"))
    state = TrainState(model, opt)
    g = torch.Generator().manual_seed(5)
    batches = [(torch.rand((2, 80, 80, 3), generator=g), torch.rand((2, 80, 80, 3), generator=g),
                torch.randn((2, 80, 80, 2), generator=g)) for _ in range(3)]
    seeds = [11, 12, 13]
    losses, grad = [], {}
    for i, ((a, b, f), s) in enumerate(zip(batches, seeds)):
        state, metrics = step(state, a, b, f, s)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad = {n: float(torch.linalg.vector_norm(opt.state[p]["exp_avg"]) / (1 - o["betas"][0]))
                    for n, p in model.named_parameters()}
    change = {n: float(torch.linalg.vector_norm(p.detach() - params0[n])) for n, p in model.named_parameters()}
    ref = ref_train.steps(params0, c["model"], batches, seeds, (64, 64), o)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for n in grad:
        assert abs(grad[n] - ref["grad"][n]) <= 1e-4 * max(ref["grad"][n], 1e-3), n
        assert abs(change[n] - ref["change"][n]) <= 1e-3 * max(ref["change"][n], 1e-6), n
