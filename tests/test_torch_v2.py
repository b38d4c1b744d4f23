"""LiteFlowNet2 (version 2) in the PyTorch port against the JAX package, and the float32 convs
of the port's entry points.

JAX ``init_params`` are carried across with ``from_jax_params``. The gate:
piv v2 and hui v2 eval at 64x96 (atol 2e-4, rtol 1e-3, the tolerance of
tests/test_model_parity.py); the piv v2 train outputs, the six-weight
``MultiScale`` loss (rtol 1e-4) and every parameter's gradient against
``jax.grad`` at 64x64, batch 1 (rtol 1e-3 with atol 1e-4 * max|g_jax| per
parameter, as tests/test_torch_train.py). The shipped version-2 losses do
not fit version 2's outputs; the port fails where JAX fails. Launches are
counted on the CPU by faking each kernel launch with its plain version.

The entry points (``estimate``, the train step, the eval step) must run their
convs with cuDNN TF32 off, whatever torch's flags say, and leave the flags as
they found them: a fake conv reads the flag while they run. Inputs are made
with numpy from seeds.
"""

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch import hui_liteflownet, kernels, piv_liteflownet
from piv_liteflownet_tpu_torch import run as port_run
from piv_liteflownet_tpu_torch.inference import estimate, to_nchw
from piv_liteflownet_tpu_torch.models import factory
from piv_liteflownet_tpu_torch.models.convert import from_jax_params
from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, PLAIN_OPS, param_shapes
from piv_liteflownet_tpu_torch.ops import correlation, rgb_warp, warp
from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_eval_step, make_train_step
from piv_liteflownet_tpu_torch.training import loss as tloss
from piv_liteflownet_tpu_torch.training import optim as toptim
from piv_liteflownet_tpu_torch.utils.flow_io import read_flow

ATOL, RTOL = 2e-4, 1e-3
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4
FAMILIES = {"piv": piv_liteflownet, "hui": hui_liteflownet}
CFGS = {"piv": factory.PIV_V2, "hui": factory.HUI_V2}
# per forward: corr49 (one per level), backwarp (M below the top level, S at every level),
# rgb_warp_norm (one per level)
LAUNCHES = {"piv": (5, 9, 5), "hui": (4, 7, 4)}


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


def _pair(h, w, seed, b=1):
    rng = np.random.default_rng(seed)
    img1 = rng.random((b, h, w, 3), dtype=np.float32)
    img2 = np.clip(img1 + 0.05 * rng.standard_normal((b, h, w, 3), dtype=np.float32), 0, 1)
    return img1, img2


def _nchw(a) -> torch.Tensor:
    return to_nchw(a, torch.device("cpu"))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _jax_model(family):
    from piv_liteflownet_tpu.models import factory as jfactory

    fn = jfactory.piv_liteflownet if family == "piv" else jfactory.hui_liteflownet
    return fn(version=2, seed=3)


def _ported(jmodel, family, device="cpu"):
    params = {k: np.asarray(v) for k, v in jmodel.params.items()}
    return FAMILIES[family](from_jax_params(CFGS[family], params), version=2, device=device)


@pytest.fixture(scope="module")
def jax_forward():
    """family -> (JAX model, inputs, JAX eval output), at 64x96."""
    import jax.numpy as jnp

    out = {}
    for seed, family in enumerate(FAMILIES):
        jmodel = _jax_model(family)
        img1, img2 = _pair(64, 96, seed)
        out[family] = (jmodel, (img1, img2),
                       np.asarray(jmodel(jnp.asarray(img1), jnp.asarray(img2))))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_param_shapes_and_config_match_jax(family, jax_forward):
    from piv_liteflownet_tpu.models.liteflownet import param_shapes as jparam_shapes

    jmodel = jax_forward[family][0]
    cfg = CFGS[family]
    assert param_shapes(cfg) == jparam_shapes(jmodel.cfg)
    assert (cfg.version, cfg.starting_scale, cfg.lowest_level, cfg.rgb_mean) == (
        jmodel.cfg.version, jmodel.cfg.starting_scale, jmodel.cfg.lowest_level, jmodel.cfg.rgb_mean)
    names = [s["name"] for s in param_shapes(cfg)]
    assert [n for n in names if n.startswith("NetE_M.0.conv_M")] == [
        f"NetE_M.0.conv_M.{i}" for i in range(0, 12, 2)]
    assert [n for n in names if n.startswith("NetE_S.0.conv_S")] == [
        f"NetE_S.0.conv_S.{i}" for i in range(0, 12, 2)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_from_jax_params_keys_and_shapes(family, jax_forward):
    from piv_liteflownet_tpu.models.convert import expected_keys, to_torch_state_dict

    jmodel = jax_forward[family][0]
    sd = from_jax_params(CFGS[family], {k: np.asarray(v) for k, v in jmodel.params.items()})
    assert list(sd) == expected_keys(jmodel.cfg)
    want = to_torch_state_dict(jmodel.cfg, jmodel.params)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    model = FAMILIES[family](sd, version=2, device="cpu")
    assert list(model.state_dict()) == list(sd)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_eval_forward_matches_jax(family, jax_forward):
    jmodel, (img1, img2), want = jax_forward[family]
    model = _ported(jmodel, family)
    with torch.no_grad():
        got = _nhwc(model(_nchw(img1), _nchw(img2)))
    assert got.shape == want.shape == (1, 64 >> (CFGS[family].lowest_level - 1),
                                       96 >> (CFGS[family].lowest_level - 1), 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_estimate_odd_size_matches_jax(jax_forward):
    from piv_liteflownet_tpu.inference import estimate as jestimate

    jmodel = jax_forward["piv"][0]
    img1, img2 = _pair(70, 100, seed=4, b=2)
    want = np.asarray(jestimate(jmodel, img1, img2))
    got = estimate(_ported(jmodel, "piv"), img1, img2).numpy()
    assert got.shape == (2, 70, 100, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# -- training ----------------------------------------------------------------------------

def _batch(b, h, w, seed):
    img1, img2 = _pair(h, w, seed, b)
    target = (3.0 * np.random.default_rng(seed + 100).standard_normal((b, h, w, 2))).astype(np.float32)
    return img1, img2, target


@pytest.fixture(scope="module")
def jax_train():
    """JAX piv v2 params, inputs, train outputs, six-weight loss, EPE and grads at 64x64 b1."""
    import jax

    from piv_liteflownet_tpu.models.liteflownet import forward
    from piv_liteflownet_tpu.training import loss as jloss

    jmodel = _jax_model("piv")
    loss_obj = jloss.MultiScale(div_scale=1 / 5, startScale=2,
                                l_weight=(0.001, 0.001, 0.001, 0.001, 0.01, 0.01))
    img1, img2, target = _batch(1, 64, 64, seed=5)

    def loss_fn(params):
        levels = forward(params, img1, img2, jmodel.cfg, True, jax.lax.Precision.HIGHEST)
        lossvalue, epevalue = loss_obj(levels, target)
        return lossvalue, (epevalue, levels)

    (lossvalue, (epevalue, levels)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jmodel.params)
    return dict(jmodel=jmodel, inputs=(img1, img2, target), loss=float(lossvalue),
                epe=float(epevalue), levels=[[np.asarray(f) for f in lv] for lv in levels],
                grads={k: np.asarray(v) for k, v in grads.items()})


def test_train_forward_loss_and_grads_match_jax(jax_train):
    ref = jax_train
    model = _ported(ref["jmodel"], "piv")
    img1, img2, target = (_nchw(a) for a in ref["inputs"])
    levels = model(img1, img2, PLAIN_OPS, train=True)
    lossvalue, epevalue = tloss.v2_multiscale()(levels, target)
    lossvalue.backward()

    assert [len(lv) for lv in levels] == [len(lv) for lv in ref["levels"]] == [3] * 5 + [1]
    assert tuple(levels[-1][0].shape) == (1, 2, 64, 64)
    for i, (got_lv, want_lv) in enumerate(zip(levels, ref["levels"])):
        for got, want in zip(got_lv, want_lv):
            np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=RTOL, err_msg=f"entry {i}")
    np.testing.assert_allclose(float(lossvalue.detach()), ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(float(epevalue.detach()), ref["epe"], rtol=1e-4)
    want_grads = from_jax_params(CFGS["piv"], ref["grads"])
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert list(grads) == list(want_grads)
    for name, got in grads.items():
        want = want_grads[name].numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(np.abs(want).max()), err_msg=name)


def test_piv_loss_version_2_raises_where_jax_asserts(jax_train):
    """Five weights for six outputs: JAX asserts (tests/test_training.py), the port raises."""
    from piv_liteflownet_tpu.training import loss as jloss

    ref = jax_train
    img1, img2, target = ref["inputs"]
    with pytest.raises(AssertionError):
        jloss.piv_loss(version=2)(ref["levels"], target)
    levels = [[_nchw(f) for f in lv] for lv in ref["levels"]]
    with pytest.raises(ValueError, match="5 loss weights vs 6 pyramid outputs"):
        tloss.piv_loss(version=2)(levels, _nchw(target))
    model = _ported(ref["jmodel"], "piv")
    opt = toptim.make_optimizer(model, 2)
    step = make_train_step(model.cfg, tloss.piv_loss(version=2), opt, ops=PLAIN_OPS)
    with pytest.raises(ValueError, match="loss weights"):
        step(TrainState(model, opt), img1, img2, target)


def test_hui_v2_train_outputs_and_hui_loss_behave_as_jax():
    """hui v2's train outputs match JAX; with ``hui_loss()`` its full-size output meets a target
    pooled by 2 (by the arithmetic of ``MultiScale``), and both packages fail on the shapes."""
    import jax.numpy as jnp

    from piv_liteflownet_tpu.training import loss as jloss

    jmodel = _jax_model("hui")
    img1, img2, target = _batch(1, 64, 64, seed=6)
    want = jmodel(jnp.asarray(img1), jnp.asarray(img2), train=True)
    model = _ported(jmodel, "hui")
    with torch.no_grad():
        got = model(_nchw(img1), _nchw(img2), PLAIN_OPS, train=True)
    assert [len(lv) for lv in got] == [len(lv) for lv in want] == [3] * 4 + [1]
    for got_lv, want_lv in zip(got, want):
        for g, w in zip(got_lv, want_lv):
            np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL, rtol=RTOL)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jloss.hui_loss()(want, jnp.asarray(target))
    with pytest.raises(RuntimeError, match="must match the size"):
        tloss.hui_loss()(got, _nchw(target))


# -- launches, faked on the CPU -----------------------------------------------------------

def _fake_kernels(monkeypatch):
    def fake_warp_bwd(img, flow, gout, stride, g_img, g_flow):
        for dst, src in zip((g_img, g_flow), warp.backwarp_bwd_plain(img, flow, gout, stride)):
            dst.copy_(src)

    def fake_corr_bwd(f1, f2, g, g_f1, g_f2):
        for dst, src in zip((g_f1, g_f2), correlation.corr49_bwd_plain(f1, f2, g)):
            dst.copy_(src)

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


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_launch_counts_with_faked_kernels(monkeypatch, family):
    _fake_kernels(monkeypatch)
    model = FAMILIES[family](seed=0, version=2, device="cpu")
    img1, img2 = _pair(64, 96, seed=2)
    got = estimate(model, img1, img2)
    assert _counts() == (LAUNCHES[family], (0, 0))
    np.testing.assert_array_equal(got, estimate(model, img1, img2, ops=PLAIN_OPS))


def test_v2_train_step_launch_counts_with_faked_kernels(monkeypatch):
    """One piv v2 step through the faked kernels: 5/9/5 forward and 5 + 9 backward launches,
    and the plain path's gradients (rtol 1e-4, atol 1e-6 * max|g|: the backward formulas sum
    in another order than autograd)."""
    _fake_kernels(monkeypatch)
    img1, img2, target = _batch(1, 64, 64, seed=7)
    grads = {}
    for name, ops in (("kernel", KERNEL_OPS), ("plain", PLAIN_OPS)):
        model = piv_liteflownet(seed=0, version=2, device="cpu")
        opt = toptim.make_optimizer(model, model.cfg.lowest_level)
        step = make_train_step(model.cfg, tloss.v2_multiscale(), opt, ops=ops)
        for mod in (correlation, warp, rgb_warp):
            mod.launches = 0
        correlation.bwd_launches = warp.bwd_launches = 0
        step(TrainState(model, opt), img1, img2, target)
        assert _counts() == (((5, 9, 5), (5, 9)) if name == "kernel" else ((0, 0, 0), (0, 0)))
        grads[name] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for n, g in grads["plain"].items():
        torch.testing.assert_close(grads["kernel"][n], g, rtol=1e-4,
                                   atol=1e-6 * float(g.abs().max()), msg=n)


def test_run_cli_version_2_writes_flo(tmp_path):
    from PIL import Image

    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    rng = np.random.default_rng(0)
    for tag in ("img1", "img2"):
        Image.fromarray((rng.random((40, 48, 3)) * 255).astype(np.uint8)).save(indir / f"p00_{tag}.png")
    port_run.main(["--model", "piv", "--version", "2", "-p", "-i", str(indir), "-o", str(outdir),
                   "--cpu"])
    flo = outdir / "PIV-LiteFlowNet-en" / "in" / "flow" / "p00_img1_out.flo"
    flow = read_flow(str(flo))
    assert flow.shape == (40, 48, 2) and np.isfinite(flow).all()
    assert "version: 2" in (outdir / "PIV-LiteFlowNet-en" / "in" / "args.txt").read_text()


def test_other_versions_raise():
    for fn in FAMILIES.values():
        with pytest.raises(ValueError, match="version"):
            fn(version=3, device="cpu")
    with pytest.raises(ValueError, match="version"):
        factory.ModelConfig(version=0)


# -- float32 convs at the entry points -----------------------------------------------------

@pytest.mark.parametrize("entry", ["estimate", "train_step", "eval_step"])
def test_entry_points_run_convs_in_f32_and_restore_the_flags(monkeypatch, entry):
    """Every conv an entry point runs, forward and backward, sees cuDNN TF32 off, though the
    flag is on (torch's default) around the call, and the flag is on again afterwards."""
    import torch.nn.functional as F

    seen = []
    conv2d = F.conv2d

    def recording_conv2d(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        out = conv2d(*args, **kwargs)
        if out.requires_grad:
            out.register_hook(lambda g: seen.append(torch.backends.cudnn.allow_tf32))
        return out

    monkeypatch.setattr(F, "conv2d", recording_conv2d)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        model = piv_liteflownet(seed=0, version=2, device="cpu")
        img1, img2, target = _batch(1, 64, 64, seed=8)
        if entry == "estimate":
            estimate(model, img1[0], img2[0])
        elif entry == "train_step":
            opt = toptim.make_optimizer(model, model.cfg.lowest_level)
            make_train_step(model.cfg, tloss.v2_multiscale(), opt)(TrainState(model, opt),
                                                                   img1, img2, target)
        else:
            make_eval_step(model.cfg, tloss.v2_multiscale())(model, img1, img2, target)
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.backends.cudnn.enabled and not torch.backends.cudnn.benchmark
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert len(seen) > 50 and not any(seen)
    if entry == "train_step":
        assert len(seen) > 2 * sum(isinstance(m, torch.nn.Conv2d) for m in model.modules()) - 5


# -- on the card ------------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("family", list(FAMILIES))
def test_v2_forward_on_card_uses_kernels_and_matches_plain_and_cpu(cuda, family):
    model = FAMILIES[family](seed=0, version=2, device=cuda)
    img1, img2 = _pair(64, 96, seed=1, b=2)
    correlation.launches = warp.launches = rgb_warp.launches = 0
    got = estimate(model, img1, img2, tensor=True)
    torch.cuda.synchronize()
    assert (correlation.launches, warp.launches, rgb_warp.launches) == LAUNCHES[family]
    torch.testing.assert_close(got, estimate(model, img1, img2, tensor=True, ops=PLAIN_OPS),
                               atol=ATOL, rtol=RTOL)
    cpu_model = FAMILIES[family](seed=0, version=2, device="cpu")
    torch.testing.assert_close(got.cpu(), estimate(cpu_model, img1, img2, tensor=True),
                               atol=ATOL, rtol=RTOL)
