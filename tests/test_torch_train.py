"""Training in the PyTorch port against the JAX package.

The gate: piv v1 and hui v1 at 64x96, batch 2, with JAX ``init_params``
carried across by ``from_jax_params``. The train forward, the multiscale
loss and the gradient of every parameter match ``jax.grad`` of the JAX loss
(float32 on the CPU, JAX at Precision.HIGHEST). Tolerances: train outputs
atol 2e-4 rtol 1e-3 (tests/test_model_parity.py's); the loss rtol 1e-4;
each parameter's gradient rtol 1e-3 with atol 1e-4 * max|g_jax| of that
parameter (the gradient sums over every pixel of a deep stack, in another
order). Optimizer steps take the same gradients on both sides, and the
parameters agree to atol 1e-6.

Without a card, the kernel path is exercised by faking each kernel launch
with its plain version (forward and backward): the gradients then equal the
plain path's, and the launch counts show that autograd went through the
kernels' ``torch.autograd.Function``s. Inputs are made with numpy from seeds.
"""

import json
import os

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch import hui_liteflownet, kernels, piv_liteflownet
from piv_liteflownet_tpu_torch.models import factory
from piv_liteflownet_tpu_torch.models.convert import from_jax_params
from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, PLAIN_OPS
from piv_liteflownet_tpu_torch.ops import correlation, rgb_warp, warp
from piv_liteflownet_tpu_torch.inference import to_nchw
from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_eval_step, make_train_step
from piv_liteflownet_tpu_torch.trainer import Train, TrainArgs, resume
from piv_liteflownet_tpu_torch.training import loss as tloss
from piv_liteflownet_tpu_torch.training import optim as toptim
from piv_liteflownet_tpu_torch.utils.checkpoint import load_metadata, restore_checkpoint
from piv_liteflownet_tpu_torch.utils.metrics import Experiment

FAMILIES = {"piv": piv_liteflownet, "hui": hui_liteflownet}
CFGS = {"piv": factory.PIV_V1, "hui": factory.HUI_V1}
LOSSES = {"piv": tloss.piv_loss, "hui": tloss.hui_loss}
OUT_ATOL, OUT_RTOL = 2e-4, 1e-3
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's CPU thread pool in each of
    them would oversubscribe the cores many times over, so these tests use one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(b, h, w, seed):
    """A pair and a raw target flow of a few pixels, NHWC."""
    rng = np.random.default_rng(seed)
    img1 = rng.random((b, h, w, 3), dtype=np.float32)
    img2 = np.clip(img1 + 0.05 * rng.standard_normal((b, h, w, 3), dtype=np.float32), 0, 1)
    target = (3.0 * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    return img1, img2, target


def _nchw(a) -> torch.Tensor:
    return to_nchw(a, torch.device("cpu"))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def jax_train():
    """family -> JAX params, inputs, train outputs, loss, EPE and grads (numpy) at 64x96 b2."""
    import jax

    from piv_liteflownet_tpu.models import factory as jfactory
    from piv_liteflownet_tpu.models.liteflownet import forward
    from piv_liteflownet_tpu.training import loss as jloss

    out = {}
    for seed, family in enumerate(FAMILIES):
        fn = jfactory.piv_liteflownet if family == "piv" else jfactory.hui_liteflownet
        jmodel = fn(version=1, seed=3)
        loss_obj = jloss.piv_loss() if family == "piv" else jloss.hui_loss()
        img1, img2, target = _batch(2, 64, 96, seed)

        def loss_fn(params):
            levels = forward(params, img1, img2, jmodel.cfg, True, jax.lax.Precision.HIGHEST)
            lossvalue, epevalue = loss_obj(levels, target)
            return lossvalue, (epevalue, levels)

        (lossvalue, (epevalue, levels)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(jmodel.params)
        out[family] = dict(
            cfg=jmodel.cfg, params={k: np.asarray(v) for k, v in jmodel.params.items()},
            inputs=(img1, img2, target), loss=float(lossvalue), epe=float(epevalue),
            levels=[[np.asarray(f) for f in lv] for lv in levels],
            grads={k: np.asarray(v) for k, v in grads.items()})
    return out


def _ported(family, params):
    return FAMILIES[family](from_jax_params(CFGS[family], params), device="cpu")


def _loss_and_grads(model, family, inputs, ops=PLAIN_OPS):
    img1, img2, target = (_nchw(a) for a in inputs)
    model.zero_grad(set_to_none=True)
    levels = model(img1, img2, ops, train=True)
    lossvalue, epevalue = LOSSES[family]()(levels, target)
    lossvalue.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return levels, float(lossvalue.detach()), float(epevalue.detach()), grads


# -- losses ------------------------------------------------------------------------------

def _level_flows(rng, b, h, w, n_levels, lowest_level):
    """Random per-level [M, S, R] flows at the sizes of the model's levels, NHWC, coarsest first."""
    levels = []
    for lv in reversed(range(lowest_level, lowest_level + n_levels)):
        s = 2 ** (lv - 1)
        levels.append([rng.standard_normal((b, h // s, w // s, 2)).astype(np.float32)
                       for _ in range(3)])
    return levels


@pytest.mark.parametrize("name", ["piv", "hui", "piv_L2", "piv_level", "hui_level", "multiscale_sum"])
def test_losses_match_jax(name):
    from piv_liteflownet_tpu.training import loss as jloss

    make = {
        "piv": lambda m: m.piv_loss(), "hui": lambda m: m.hui_loss(),
        "piv_L2": lambda m: m.piv_loss(norm="L2"),
        "piv_level": lambda m: m.piv_loss(level_eval=True),
        "hui_level": lambda m: m.hui_loss(level_eval=True),
        "multiscale_sum": lambda m: m.MultiScale(div_scale=0.2, startScale=1, use_mean=False,
                                                 l_weight=(1, 2, 3, 4, 5, 6), norm="L2"),
    }[name]
    lowest = 2 if name.startswith("hui") else 1
    rng = np.random.default_rng(len(name))
    levels = _level_flows(rng, 2, 64, 96, 7 - lowest, lowest)
    target = (3.0 * rng.standard_normal((2, 64, 96, 2))).astype(np.float32)
    want = make(jloss)(levels, target)
    got = make(tloss)([[_nchw(f) for f in lv] for lv in levels], _nchw(target))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray([float(x) for x in np.atleast_1d(g)]),
                                   np.asarray([float(x) for x in np.atleast_1d(w)]), rtol=1e-5)
    if not name.endswith("level"):  # the eval branch: one flow against the pooled target
        flow = rng.standard_normal((2, 64 >> (lowest - 1), 96 >> (lowest - 1), 2)).astype(np.float32)
        want = make(jloss)(flow, target)
        got = make(tloss)(_nchw(flow), _nchw(target))
        np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-5)


@pytest.mark.parametrize("cls", ["L1Loss", "L2Loss"])
def test_flat_losses_and_epe_match_jax(cls):
    from piv_liteflownet_tpu.training import loss as jloss

    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((2, 12, 20, 2)).astype(np.float32) for _ in range(2))
    want = getattr(jloss, cls)(mul_scale=2.5)(a, b)
    got = getattr(tloss, cls)(mul_scale=2.5)(_nchw(a), _nchw(b))
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-5)
    for mean in (True, False):
        np.testing.assert_allclose(float(tloss.EPE(_nchw(a), _nchw(b), mean)),
                                   float(jloss.EPE(a, b, mean)), rtol=1e-5)


def test_multiscale_rejects_a_wrong_number_of_levels():
    with pytest.raises(ValueError, match="loss weights"):
        tloss.piv_loss()([[torch.zeros(1, 2, 4, 4)]], torch.zeros(1, 2, 4, 4))
    with pytest.raises(ValueError):
        tloss.piv_loss(version=3)


# -- the gate: train forward, loss and grads against jax.grad -----------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_forward_loss_and_grads_match_jax(family, jax_train):
    ref = jax_train[family]
    model = _ported(family, ref["params"])
    levels, lossvalue, epevalue, grads = _loss_and_grads(model, family, ref["inputs"])

    assert len(levels) == len(ref["levels"]) == 7 - CFGS[family].lowest_level
    for i, (got_lv, want_lv) in enumerate(zip(levels, ref["levels"])):
        assert len(got_lv) == len(want_lv) == 3
        for got, want in zip(got_lv, want_lv):
            np.testing.assert_allclose(_nhwc(got), want, atol=OUT_ATOL, rtol=OUT_RTOL,
                                       err_msg=f"level entry {i}")
    np.testing.assert_allclose(lossvalue, ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(epevalue, ref["epe"], rtol=1e-4)

    want_grads = from_jax_params(CFGS[family], ref["grads"])
    assert list(grads) == list(want_grads)
    for name, got in grads.items():
        want = want_grads[name].numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(np.abs(want).max()), err_msg=name)
    # the train forward's last flow is the eval forward before its scale
    with torch.no_grad():
        img1, img2, _ = (_nchw(a) for a in ref["inputs"])
        torch.testing.assert_close(model(img1, img2, PLAIN_OPS),
                                   levels[-1][-1].detach() * CFGS[family].scale_factor(1))


@pytest.mark.parametrize("optimizer,kw", [
    ("Adam", {}), ("AdamW", {}), ("SGD", {"momentum": 0.9}),
])
def test_optimizer_steps_match_jax(jax_train, optimizer, kw):
    """Two steps of the four-group optimizer, fed the same (JAX) gradients on both sides."""
    import jax
    import optax

    from piv_liteflownet_tpu.training.optim import make_optimizer as jmake_optimizer

    ref = jax_train["piv"]
    cfg = CFGS["piv"]
    params = dict(ref["params"])
    tx, _ = jmake_optimizer(params, cfg.lowest_level, optimizer=optimizer, **kw)
    opt_state = tx.init(params)

    @jax.jit
    def jstep(params, opt_state):
        updates, opt_state = tx.update(ref["grads"], opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(2):
        params, opt_state = jstep(params, opt_state)
    want = from_jax_params(cfg, {k: np.asarray(v) for k, v in params.items()})

    model = _ported("piv", ref["params"])
    opt = toptim.make_optimizer(model, cfg.lowest_level, optimizer=optimizer, **kw)
    grads = from_jax_params(cfg, ref["grads"])
    for _ in range(2):
        for name, p in model.named_parameters():
            p.grad = grads[name].clone()
        opt.step()
    got = model.state_dict()
    moved = 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=name)
        moved += not np.array_equal(w.numpy(), from_jax_params(cfg, ref["params"])[name].numpy())
    # Adam's first steps move every parameter by about lr; SGD's can be below float resolution
    assert moved == len(want) if optimizer != "SGD" else moved > 0


def test_param_groups_match_jax_labels(jax_train):
    from piv_liteflownet_tpu.training.optim import param_group_labels as jlabels

    for family in FAMILIES:
        cfg = CFGS[family]
        model = _ported(family, jax_train[family]["params"])
        names = [n for n, _ in model.named_parameters()]
        labels = toptim.param_group_labels(names, cfg.lowest_level)
        assert labels == jlabels(jax_train[family]["params"], cfg.lowest_level)
        opt = toptim.make_optimizer(model, cfg.lowest_level, lr=1e-3, low_lr=6e-5,
                                    weight_decay=4e-4, bias_decay=0.0)
        by_name = {id(p): n for n, p in model.named_parameters()}
        for group in opt.param_groups:
            assert {labels[by_name[id(p)]] for p in group["params"]} == {group["name"]}
            lo = group["name"].endswith("_lo")
            assert group["lr"] == (6e-5 if lo else 1e-3)
            assert group["weight_decay"] == (4e-4 if group["name"][0] == "w" else 0.0)
        assert sum(len(g["params"]) for g in opt.param_groups) == len(names)


@pytest.mark.parametrize("name,kw", [
    ("MultiStepLR", {"milestones": [-1, 3], "gamma": 0.5}), ("StepLR", {"step_size": 2}),
    ("ExponentialLR", {}), ("CosineAnnealingLR", {"T_max": 7}), ("ConstantLR", {}), ("None", {}),
])
def test_schedules_match_jax(name, kw):
    from piv_liteflownet_tpu.training.optim import schedule_lr as jschedule

    for epoch in range(0, 9):
        assert toptim.schedule_lr(name, 1e-3, epoch, unknown=1, **kw) == pytest.approx(
            jschedule(name, 1e-3, epoch, unknown=1, **kw), rel=1e-12)


def test_set_group_lrs_and_unported_optimizers():
    model = hui_liteflownet(device="cpu")
    opt = toptim.make_optimizer(model, 2, optimizer="rmsprop", alpha=0.9, betas=[0.5, 0.5])
    assert isinstance(opt, torch.optim.RMSprop) and opt.defaults["alpha"] == 0.9
    toptim.set_group_lrs(opt, {"w_hi": 0.5, "b_lo": 0.25})
    assert {g["name"]: g["lr"] for g in opt.param_groups} == {
        "w_lo": 6e-5, "w_hi": 0.5, "b_lo": 0.25, "b_hi": 1e-3}
    for name in toptim.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            toptim.make_optimizer(model, 2, optimizer=name)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer(model, 2, optimizer="Sgdx")
    for option in ({"mesh": object()}, {"pipeline": object()}, {"remat": True},
                   {"compute_dtype": torch.float16}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make_train_step(model.cfg, tloss.hui_loss(), opt, **option)


# -- the kernel path without a card: autograd through faked launches -------------------------

def _fake_kernels(monkeypatch):
    """Route every tensor to the kernel wrappers, whose launches run the plain versions."""
    def fake_warp_bwd(img, flow, gout, stride, g_img, g_flow):
        a, b = warp.backwarp_bwd_plain(img, flow, gout, stride)
        g_img.copy_(a)
        g_flow.copy_(b)

    def fake_corr_bwd(f1, f2, g, g_f1, g_f2):
        a, b = correlation.corr49_bwd_plain(f1, f2, g)
        g_f1.copy_(a)
        g_f2.copy_(b)

    monkeypatch.setattr(kernels, "on_cuda", lambda op, *tensors: True)
    monkeypatch.setattr(correlation, "_launch",
                        lambda f1, f2, out: out.copy_(correlation.corr49_plain(f1, f2)))
    monkeypatch.setattr(warp, "_launch",
                        lambda img, flow, s, out: out.copy_(warp.backwarp_plain(img, flow, s)))
    monkeypatch.setattr(rgb_warp, "_launch",
                        lambda a, b, f, out: out.copy_(rgb_warp.rgb_warp_norm_plain(a, b, f)))
    monkeypatch.setattr(warp, "_launch_bwd", fake_warp_bwd)
    monkeypatch.setattr(correlation, "_launch_bwd", fake_corr_bwd)
    for mod in (correlation, warp, rgb_warp):
        monkeypatch.setattr(mod, "launches", 0)
    for mod in (correlation, warp):
        monkeypatch.setattr(mod, "bwd_launches", 0)


def _counts():
    return ((correlation.launches, warp.launches, rgb_warp.launches),
            (correlation.bwd_launches, warp.bwd_launches))


@pytest.mark.parametrize("family,fwd,bwd", [("piv", (6, 11, 6), (6, 11)), ("hui", (5, 9, 5), (5, 9))])
def test_train_step_through_faked_kernels(monkeypatch, family, fwd, bwd):
    """One train step per path: the kernel path's gradients and updated params equal the
    plain path's (rtol 1e-4, atol 1e-6 * max|g|: the explicit backward formulas sum in
    another order than autograd), with 6/11/6 forward and 6 + 11 backward launches (piv)."""
    _fake_kernels(monkeypatch)
    img1, img2, target = _batch(2, 64, 96, seed=7)
    results = {}
    for name, ops in (("kernel", KERNEL_OPS), ("plain", PLAIN_OPS)):
        model = FAMILIES[family](seed=0, device="cpu")
        opt = toptim.make_optimizer(model, model.cfg.lowest_level)
        step = make_train_step(model.cfg, LOSSES[family](), opt, ops=ops)
        for mod in (correlation, warp, rgb_warp):
            mod.launches = 0
        correlation.bwd_launches = warp.bwd_launches = 0
        state, metrics = step(TrainState(model, opt), img1, img2, target)
        results[name] = (_counts(), float(metrics["loss"]),
                         {n: p.grad.clone() for n, p in model.named_parameters()},
                         model.state_dict())
        assert state.step == 1
    assert results["kernel"][0] == (fwd, bwd)
    assert results["plain"][0] == ((0, 0, 0), (0, 0))
    assert results["kernel"][1] == pytest.approx(results["plain"][1], rel=1e-6)
    for n, g in results["plain"][2].items():
        torch.testing.assert_close(results["kernel"][2][n], g, rtol=1e-4,
                                   atol=1e-6 * float(g.abs().max()), msg=n)
    for n, p in results["plain"][3].items():
        torch.testing.assert_close(results["kernel"][3][n], p, rtol=0, atol=1e-6, msg=n)


# -- the epoch loop, checkpoints and resume ---------------------------------------------------

def _loaders(seed):
    train = []
    for i in range(2):
        im1, im2, t = _batch(1, 64, 64, seed + i)
        train.append(((im1, im2), t))
    im1, im2, t = _batch(1, 80, 70, seed + 9)  # centre-cropped to 64x64
    return {"train": train, "val": [((im1, im2), t)]}


def _trainer(save, total_epochs, workdir):
    model = piv_liteflownet(seed=5, device="cpu")
    opt = toptim.make_optimizer(model, model.cfg.lowest_level)
    loss_obj = tloss.piv_loss(norm="L2")
    args = TrainArgs(total_epochs=total_epochs, backup_frequency=1, save=save,
                     lr_scheduler_kwargs={"milestones": [1], "gamma": 0.5})
    state = TrainState(model, opt)
    return Train(args, Experiment(workdir=workdir), _loaders(3), state,
                 make_train_step(model.cfg, loss_obj, opt), make_eval_step(model.cfg, loss_obj))


def test_resume_equals_uninterrupted(tmp_path):
    """2 epochs of 2 steps == 1 epoch + resume from ``backup_1`` + 1 epoch: params, Adam
    moments, step count and lrs survive the checkpoint (tests/test_training.py's contract)."""
    a = _trainer(str(tmp_path / "a"), 2, str(tmp_path / "exp"))
    a()
    b = _trainer(str(tmp_path / "b"), 1, str(tmp_path / "exp"))
    b()
    c = _trainer(str(tmp_path / "b"), 2, str(tmp_path / "exp"))
    resume(c.state, str(tmp_path / "b" / "backup_1"), c.args)
    assert c.args.start_epoch == 2 and c.state.step == 2
    c()

    for save in ("a", "b"):
        names = set(os.listdir(tmp_path / save))
        assert {"LiteFlowNet_checkpoint", "LiteFlowNet_model_best", "backup_1", "backup_2",
                "backup_2.meta.json", "LiteFlowNet_checkpoint.meta.json"} <= names
    ck_a = restore_checkpoint(str(tmp_path / "a" / "backup_2"))
    ck_b = restore_checkpoint(str(tmp_path / "b" / "backup_2"))
    assert ck_a["epoch"] == ck_b["epoch"] == 2 and ck_a["step"] == ck_b["step"] == 4
    assert ck_a["best_epe"] == pytest.approx(ck_b["best_epe"], rel=1e-6)
    for k, v in ck_a["model"].items():
        torch.testing.assert_close(ck_b["model"][k], v, rtol=0, atol=1e-6, msg=k)
    sa, sb = ck_a["optimizer"]["state"], ck_b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) == len(list(a.state.model.parameters()))
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sb[i][key], sa[i][key], rtol=0, atol=1e-6)
    # the schedule halved the lr after epoch 1 (milestone 1): epoch 2 ran, and ends, at half
    assert {g["name"]: g["lr"] for g in ck_a["optimizer"]["param_groups"]} == pytest.approx({
        "w_lo": 3e-5, "w_hi": 5e-4, "b_lo": 3e-5, "b_hi": 5e-4})
    meta = load_metadata(str(tmp_path / "a" / "backup_2"))
    assert meta["epoch"] == 2 and meta["arch"] == "LiteFlowNet"
    records = [json.loads(line) for line in open(
        os.path.join(a.experiment.dir, "metrics.jsonl"))]
    batch_steps = [r["step"] for r in records if r.get("metric") == "train_batch_MultiScale-L2"]
    assert batch_steps == [1, 2, 3, 4]
    assert any(r.get("metric") == "val_MultiScale-L2" for r in records)


# -- on the card ----------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("family,fwd,bwd", [("piv", (6, 11, 6), (6, 11)), ("hui", (5, 9, 5), (5, 9))])
def test_train_step_on_card_uses_kernels_and_matches_plain(cuda, family, fwd, bwd):
    """Kernel and plain paths on the card, one step each from the same weights: gradients
    within rtol 1e-3, atol 1e-4 * max|g| (atomics and cuDNN's backward vary in order)."""
    img1, img2, target = _batch(2, 64, 96, seed=4)
    grads, counts = {}, {}
    for name, ops in (("kernel", KERNEL_OPS), ("plain", PLAIN_OPS)):
        model = FAMILIES[family](seed=0, device=cuda)
        opt = toptim.make_optimizer(model, model.cfg.lowest_level)
        step = make_train_step(model.cfg, LOSSES[family](), opt, ops=ops)
        for mod in (correlation, warp, rgb_warp):
            mod.launches = 0
        correlation.bwd_launches = warp.bwd_launches = 0
        _, metrics = step(TrainState(model, opt), img1, img2, target)
        torch.cuda.synchronize()
        counts[name] = _counts()
        assert np.isfinite(float(metrics["loss"]))
        grads[name] = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert counts["kernel"] == (fwd, bwd) and counts["plain"] == ((0, 0, 0), (0, 0))
    for n, g in grads["plain"].items():
        torch.testing.assert_close(grads["kernel"][n], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(g.abs().max()), msg=n)
