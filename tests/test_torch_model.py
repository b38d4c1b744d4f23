"""The PyTorch port's model against the JAX package.

JAX ``init_params`` are carried across with ``from_jax_params``; both models
run the eval forward on the same numpy inputs on the CPU. Tolerance: atol
2e-4, rtol 1e-3, as tests/test_model_parity.py holds the JAX model to the
reference (float32, TF32 off, JAX at Precision.HIGHEST). The JAX outputs
are shared through module-scoped fixtures.
"""

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch import hui_liteflownet, piv_liteflownet
from piv_liteflownet_tpu_torch.inference import estimate
from piv_liteflownet_tpu_torch.models import factory
from piv_liteflownet_tpu_torch.models.convert import from_jax_params
from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, PLAIN_OPS, param_shapes
from piv_liteflownet_tpu_torch.ops import correlation, rgb_warp, warp

ATOL, RTOL = 2e-4, 1e-3
FAMILIES = {"piv": piv_liteflownet, "hui": hui_liteflownet}
CFGS = {"piv": factory.PIV_V1, "hui": factory.HUI_V1}


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


def _jax_model(family):
    from piv_liteflownet_tpu.models import factory as jfactory

    fn = jfactory.piv_liteflownet if family == "piv" else jfactory.hui_liteflownet
    return fn(version=1, seed=3)


def _ported(jmodel, family, device="cpu"):
    params = {k: np.asarray(v) for k, v in jmodel.params.items()}
    return FAMILIES[family](from_jax_params(CFGS[family], params), version=1, device=device)


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
def test_param_shapes_match_jax(family, jax_forward):
    jmodel = jax_forward[family][0]
    from piv_liteflownet_tpu.models.liteflownet import param_shapes as jparam_shapes

    cfg = CFGS[family]
    assert param_shapes(cfg) == jparam_shapes(jmodel.cfg)
    assert (cfg.starting_scale, cfg.lowest_level, cfg.rgb_mean) == (
        jmodel.cfg.starting_scale, jmodel.cfg.lowest_level, jmodel.cfg.rgb_mean)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_from_jax_params_keys_and_shapes(family, jax_forward):
    from piv_liteflownet_tpu.models.convert import expected_keys, to_torch_state_dict

    jmodel = jax_forward[family][0]
    sd = from_jax_params(CFGS[family], {k: np.asarray(v) for k, v in jmodel.params.items()})
    assert list(sd) == expected_keys(jmodel.cfg)
    want = to_torch_state_dict(jmodel.cfg, jmodel.params)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    model = FAMILIES[family](sd, version=1, device="cpu")
    assert list(model.state_dict()) == list(sd)
    assert all(model.state_dict()[k].shape == v.shape for k, v in sd.items())


def test_from_jax_params_rejects_bad_params(jax_forward):
    jmodel = jax_forward["piv"][0]
    cfg = CFGS["piv"]
    params = {k: np.asarray(v) for k, v in jmodel.params.items()}
    with pytest.raises(KeyError):
        from_jax_params(cfg, {k: v for k, v in params.items() if not k.startswith("NetE_R.0")})
    params["NetC.conv1.0.weight"] = params["NetC.conv1.0.weight"][..., :16]
    with pytest.raises(ValueError, match="NetC.conv1.0.weight"):
        from_jax_params(cfg, params)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_eval_forward_matches_jax(family, jax_forward):
    jmodel, (img1, img2), want = jax_forward[family]
    model = _ported(jmodel, family)
    t1 = torch.from_numpy(img1).permute(0, 3, 1, 2)
    t2 = torch.from_numpy(img2).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(t1, t2).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_estimate_odd_size_matches_jax(jax_forward):
    from piv_liteflownet_tpu.inference import estimate as jestimate

    jmodel = jax_forward["piv"][0]
    img1, img2 = _pair(70, 100, seed=4, b=2)
    want = np.asarray(jestimate(jmodel, img1, img2))
    model = _ported(jmodel, "piv")
    got = estimate(model, img1, img2).numpy()
    assert got.shape == (2, 70, 100, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    single = estimate(model, img1[0], img2[0])
    assert isinstance(single, np.ndarray) and single.shape == (70, 100, 2)
    np.testing.assert_allclose(single, got[0], atol=1e-5)


def test_estimate_rejects_mismatched_frames():
    model = piv_liteflownet(device="cpu")
    with pytest.raises(ValueError, match="same shape"):
        estimate(model, np.zeros((32, 32, 3), np.float32), np.zeros((32, 64, 3), np.float32))


def test_seeded_init_is_deterministic_and_bounded():
    a = piv_liteflownet(seed=0, device="cpu").state_dict()
    b = piv_liteflownet(seed=0, device="cpu").state_dict()
    c = piv_liteflownet(seed=1, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["NetC.conv1.0.weight"], c["NetC.conv1.0.weight"])
    # torch's default bound 1/sqrt(fan_in): conv1 fan_in = 3*7*7; depthwise deconv fan_in = 16
    assert float(a["NetC.conv1.0.weight"].abs().max()) <= 1 / np.sqrt(147)
    assert float(a["NetE_M.0.upCorr_M.weight"].abs().max()) <= 0.25


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in FAMILIES.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(version=1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(version=1, device="cuda")


def test_version_2_is_not_ported_yet():
    """Version 2 is ported now (tests/test_torch_v2.py); other versions raise."""
    with pytest.raises(ValueError, match="version"):
        piv_liteflownet(version=3, device="cpu")
    with pytest.raises(ValueError):
        hui_liteflownet(version=3, device="cpu")
    assert factory.PIV_V1.levels == [1, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("family,counts", [("piv", (6, 11, 6)), ("hui", (5, 9, 5))])
def test_forward_launch_counts_with_faked_kernels(monkeypatch, family, counts):
    """Launch counting on the CPU: every tensor is routed to a fake launch that runs the plain version."""
    from piv_liteflownet_tpu_torch import kernels

    monkeypatch.setattr(kernels, "on_cuda", lambda op, *tensors: True)
    monkeypatch.setattr(correlation, "_launch",
                        lambda f1, f2, out: out.copy_(correlation.corr49_plain(f1, f2)))
    monkeypatch.setattr(warp, "_launch",
                        lambda img, flow, s, out: out.copy_(warp.backwarp_plain(img, flow, s)))
    monkeypatch.setattr(rgb_warp, "_launch",
                        lambda a, b, f, out: out.copy_(rgb_warp.rgb_warp_norm_plain(a, b, f)))
    for mod in (correlation, warp, rgb_warp):
        monkeypatch.setattr(mod, "launches", 0)
    model = FAMILIES[family](seed=0, device="cpu")
    img1, img2 = _pair(64, 96, seed=2)
    got = estimate(model, img1, img2)
    assert (correlation.launches, warp.launches, rgb_warp.launches) == counts
    want = estimate(model, img1, img2, ops=PLAIN_OPS)
    np.testing.assert_array_equal(got, want)
    assert (correlation.launches, warp.launches, rgb_warp.launches) == counts


# -- on the card -------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("family,counts", [("piv", (6, 11, 6)), ("hui", (5, 9, 5))])
def test_forward_on_card_uses_kernels_and_matches_plain(cuda, family, counts):
    model = FAMILIES[family](seed=0, device=cuda)
    img1, img2 = _pair(64, 96, seed=1, b=2)
    t1 = torch.from_numpy(img1).permute(0, 3, 1, 2).contiguous().to(cuda)
    t2 = torch.from_numpy(img2).permute(0, 3, 1, 2).contiguous().to(cuda)
    correlation.launches = warp.launches = rgb_warp.launches = 0
    with torch.no_grad():
        got = model(t1, t2, KERNEL_OPS)
        torch.cuda.synchronize()
        assert (correlation.launches, warp.launches, rgb_warp.launches) == counts
        want = model(t1, t2, PLAIN_OPS)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    cpu_model = FAMILIES[family](seed=0, device="cpu")
    with torch.no_grad():
        ref = cpu_model(t1.cpu(), t2.cpu())
    torch.testing.assert_close(got.cpu(), ref, atol=ATOL, rtol=RTOL)
