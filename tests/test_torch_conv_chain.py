"""The conv chain of the PyTorch port (``ops/conv_chain.py``) against the JAX package.

``conv_chain_plain`` is held to JAX ``conv_chain_xla`` and to the TPU kernel
``conv_chain_pallas`` in interpret mode, with tests/test_pallas_conv.py's
tolerances (atol 2e-5, or 5e-5 for the 130-channel split stack, rtol 1e-4:
float32 sums over up to 130 x 49 taps in another order). The model with
``conv_impl="chain"`` (plain ops on the CPU) is held to the JAX forward with
``conv_impl="pallas"``, which JAX routes to XLA convs on the CPU, at 128x128,
where two or three levels take the chain (atol 2e-4, rtol 1e-3, the parity
tolerance of tests/test_model_parity.py). Without a card, launches are
counted by faking each kernel launch with its plain version. The ``gpu``
cases hold the CUDA kernel to its plain version on the card. Inputs are made
with numpy from seeds.
"""

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch import kernels, piv_liteflownet
from piv_liteflownet_tpu_torch.inference import estimate
from piv_liteflownet_tpu_torch.kernels import build
from piv_liteflownet_tpu_torch.models import factory
from piv_liteflownet_tpu_torch.models.convert import from_jax_params
from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, PLAIN_OPS
from piv_liteflownet_tpu_torch.ops import conv_chain as cc
from piv_liteflownet_tpu_torch.ops import correlation, rgb_warp, warp
from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_train_step
from piv_liteflownet_tpu_torch.training import loss as tloss
from piv_liteflownet_tpu_torch.training import optim as toptim

ATOL, RTOL = 2e-5, 1e-4
MODEL_ATOL, MODEL_RTOL = 2e-4, 1e-3

# name -> ([(k, cin, cout), ...], part channels, (b, h, w), last_linear, atol)
CASES = {
    "single_conv": ([(3, 16, 24)], [16], (1, 40, 48), True, ATOL),
    "v1_s_split_parts": ([(3, 130, 32), (3, 32, 24), (3, 24, 16), (7, 16, 2)], [64, 64, 2],
                         (2, 48, 56), True, 5e-5),
    "v2_six_convs_halo_8": ([(3, 49, 16), (3, 16, 16), (3, 16, 12), (3, 12, 8), (3, 8, 8),
                             (7, 8, 2)], [49], (1, 40, 40), True, ATOL),
    "odd_35x41": ([(3, 8, 16), (3, 16, 8)], [8], (1, 35, 41), True, ATOL),
    "last_activation": ([(3, 8, 8), (3, 8, 4)], [8], (1, 24, 24), False, ATOL),
    "parts_1_2_192": ([(3, 195, 16), (3, 16, 8)], [1, 2, 192], (1, 24, 40), False, ATOL),
}


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


def _chain(seed, shapes, parts_c, b, h, w):
    """NHWC parts and HWIO weights as numpy, as tests/test_pallas_conv.py makes them."""
    rng = np.random.default_rng(seed)
    parts = [(rng.standard_normal((b, h, w, c)) * 0.5).astype(np.float32) for c in parts_c]
    weights, biases = [], []
    for k, cin, cout in shapes:
        weights.append((rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32))
        biases.append((rng.standard_normal(cout) * 0.1).astype(np.float32))
    return parts, weights, biases


def _to_torch(parts, weights, biases, device="cpu"):
    tparts = [torch.from_numpy(np.ascontiguousarray(p.transpose(0, 3, 1, 2))).to(device) for p in parts]
    tweights = [torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(device) for w in weights]
    return tparts, tweights, [torch.from_numpy(b).to(device) for b in biases]


def _plain_nhwc(parts, weights, biases, last_linear):
    out = cc.conv_chain_plain(*_to_torch(parts, weights, biases), last_linear)
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_conv_chain_xla(name):
    from piv_liteflownet_tpu.ops.pallas_conv import conv_chain_xla

    shapes, parts_c, (b, h, w), last_linear, atol = CASES[name]
    parts, weights, biases = _chain(len(name), shapes, parts_c, b, h, w)
    want = np.asarray(conv_chain_xla(parts, weights, biases, last_linear=last_linear,
                                     precision="highest"))
    got = _plain_nhwc(parts, weights, biases, last_linear)
    assert got.shape == (b, h, w, shapes[-1][2])
    np.testing.assert_allclose(got, want, atol=atol, rtol=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_tpu_kernel_interpret(name):
    from piv_liteflownet_tpu.ops.pallas_conv import conv_chain_pallas

    shapes, parts_c, (b, h, w), last_linear, atol = CASES[name]
    parts, weights, biases = _chain(len(name), shapes, parts_c, b, h, w)
    want = np.asarray(conv_chain_pallas(parts, weights, biases, last_linear=last_linear,
                                        tile_h=16, tile_w=24, interpret=True))
    got = _plain_nhwc(parts, weights, biases, last_linear)
    np.testing.assert_allclose(got, want, atol=atol, rtol=RTOL)


# -- the model with conv_impl="chain" ----------------------------------------------

def _pair(h, w, seed, b=1):
    rng = np.random.default_rng(seed)
    img1 = rng.random((b, h, w, 3), dtype=np.float32)
    img2 = np.clip(img1 + 0.05 * rng.standard_normal((b, h, w, 3), dtype=np.float32), 0, 1)
    return img1, img2


@pytest.mark.parametrize("version", [1, 2])
def test_chain_model_matches_jax_pallas_forward(version):
    import dataclasses

    import jax.numpy as jnp

    from piv_liteflownet_tpu.models import factory as jfactory
    from piv_liteflownet_tpu.models.liteflownet import forward

    jmodel = jfactory.piv_liteflownet(version=version, seed=5)
    img1, img2 = _pair(128, 128, seed=version)
    jcfg = dataclasses.replace(jmodel.cfg, conv_impl="pallas")
    want = np.asarray(forward(jmodel.params, jnp.asarray(img1), jnp.asarray(img2), jcfg,
                              precision="highest"))
    params = {k: np.asarray(v) for k, v in jmodel.params.items()}
    model = piv_liteflownet(from_jax_params(factory.config("piv", version), params),
                            version=version, device="cpu", conv_impl="chain")
    with torch.no_grad():
        got = model(torch.from_numpy(img1).permute(0, 3, 1, 2).contiguous(),
                    torch.from_numpy(img2).permute(0, 3, 1, 2).contiguous(), PLAIN_OPS)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=MODEL_ATOL, rtol=MODEL_RTOL)


def _fake_chain(monkeypatch):
    """Route every tensor to the kernel wrappers; each launch runs the plain version and the
    chain's launches record the level size they ran at."""
    sizes = []

    def fake_chain(parts, weights, biases, last_linear, out):
        sizes.append(tuple(parts[0].shape[2:]))
        out.copy_(cc.conv_chain_plain(parts, weights, biases, last_linear))

    def fake_warp_bwd(img, flow, gout, stride, g_img, g_flow):
        for dst, src in zip((g_img, g_flow), warp.backwarp_bwd_plain(img, flow, gout, stride)):
            dst.copy_(src)

    def fake_corr_bwd(f1, f2, g, g_f1, g_f2):
        for dst, src in zip((g_f1, g_f2), correlation.corr49_bwd_plain(f1, f2, g)):
            dst.copy_(src)

    monkeypatch.setattr(kernels, "on_cuda", lambda op, *tensors: True)
    monkeypatch.setattr(warp, "_launch_bwd", fake_warp_bwd)
    monkeypatch.setattr(correlation, "_launch_bwd", fake_corr_bwd)
    monkeypatch.setattr(correlation, "_launch",
                        lambda f1, f2, out: out.copy_(correlation.corr49_plain(f1, f2)))
    monkeypatch.setattr(warp, "_launch",
                        lambda img, flow, s, out: out.copy_(warp.backwarp_plain(img, flow, s)))
    monkeypatch.setattr(rgb_warp, "_launch",
                        lambda a, b, f, out: out.copy_(rgb_warp.rgb_warp_norm_plain(a, b, f)))
    monkeypatch.setattr(cc, "_launch", fake_chain)
    for mod in (correlation, warp, rgb_warp, cc):
        monkeypatch.setattr(mod, "launches", 0)
    return sizes


@pytest.mark.parametrize("version,conv_impl,levels", [
    (1, "chain", [32, 64, 128]), (2, "chain", [32, 64]), (1, "cudnn", []),
])
def test_chain_launches_per_level_with_faked_kernels(monkeypatch, version, conv_impl, levels):
    """At 128x128: one launch per M, S and R stack of each level of at least 32x32, coarse to
    fine, and none with conv_impl="cudnn"; the result equals the plain-ops forward's."""
    sizes = _fake_chain(monkeypatch)
    model = piv_liteflownet(seed=0, version=version, device="cpu", conv_impl=conv_impl)
    img1, img2 = _pair(128, 128, seed=3)
    got = estimate(model, img1[0], img2[0])
    assert sizes == [(s, s) for s in levels for _ in range(3)]
    assert cc.launches == len(sizes)
    n_levels = 7 - model.cfg.lowest_level
    assert (correlation.launches, warp.launches, rgb_warp.launches) == (
        n_levels, 2 * n_levels - 1, n_levels)
    want = estimate(model, img1[0], img2[0], ops=PLAIN_OPS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("version", [1, 2])
def test_train_forward_never_launches_the_chain(monkeypatch, version):
    _fake_chain(monkeypatch)
    model = piv_liteflownet(seed=0, version=version, device="cpu", conv_impl="chain")
    opt = toptim.make_optimizer(model, model.cfg.lowest_level)
    loss = tloss.piv_loss() if version == 1 else tloss.v2_multiscale()
    step = make_train_step(model.cfg, loss, opt, ops=KERNEL_OPS)
    rng = np.random.default_rng(4)
    img1, img2 = _pair(64, 64, seed=4)
    target = rng.standard_normal((1, 64, 64, 2)).astype(np.float32)
    state, metrics = step(TrainState(model, opt), img1, img2, target)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    assert cc.launches == 0 and correlation.launches == 7 - model.cfg.lowest_level


def test_wrapper_raises_when_a_gradient_is_required():
    parts, weights, biases = _to_torch(*_chain(0, [(3, 4, 4), (3, 4, 2)], [4], 1, 8, 8))
    weights[0].requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        cc.conv_chain(parts, weights, biases)
    with torch.no_grad():
        out = cc.conv_chain(parts, weights, biases)
    assert out.shape == (1, 2, 8, 8) and not out.requires_grad
    # the eval forward of a chain model with grad mode on
    model = piv_liteflownet(seed=0, version=2, device="cpu", conv_impl="chain")
    img = torch.zeros(1, 3, 64, 64)
    with pytest.raises(RuntimeError, match="forward only"):
        model(img, img)


@pytest.mark.parametrize("call,err,match", [
    (lambda t: cc.conv_chain([t(1, 4, 8, 8)], [t(2, 4, 3, 3)], [t(3)]), ValueError, "bias"),
    (lambda t: cc.conv_chain([t(1, 4, 8, 8)], [t(2, 5, 3, 3)], [t(2)]), ValueError, r"\[Cout,4"),
    (lambda t: cc.conv_chain([t(1, 4, 8, 8)], [t(2, 4, 2, 2)], [t(2)]), ValueError, "k in"),
    (lambda t: cc.conv_chain([t(1, 4, 8, 8), t(1, 4, 8, 9)], [t(2, 8, 3, 3)], [t(2)]),
     ValueError, "one B, H and W"),
    (lambda t: cc.conv_chain([t(1, 1, 8, 8)] * 4, [t(2, 4, 3, 3)], [t(2)]), ValueError, "1-3 parts"),
    (lambda t: cc.conv_chain([t(1, 4, 8, 8)], [t(2, 4, 3, 3).double()], [t(2)]), TypeError, "float32"),
    (lambda t: cc.conv_chain([t(1, 4, 8, 8).to("meta")], [t(2, 4, 3, 3).to("meta")], [t(2).to("meta")]),
     ValueError, "no kernel or plain path"),
])
def test_wrapper_checks_its_operands(call, err, match):
    with pytest.raises(err, match=match):
        call(torch.zeros)


def test_packed_weights_layout_and_cache():
    _, weights, biases = _to_torch(*_chain(1, [(3, 5, 16), (7, 16, 2)], [5], 1, 4, 4))
    packed, plans = cc._packed(weights, biases)
    p0, p1 = plans
    assert (p0.path, p0.bn, p0.cin_pad, p0.cout_pad) == ("mma", 32, 16, 32)
    # the tensor-core layer: [cout/32][chunk][ky][kx][hi|lo][32][ci 16], cin and cout padded with 0
    hl = packed[:p0.weight_elems].view(1, 1, 3, 3, 2, 32, 16).permute(4, 0, 5, 1, 6, 2, 3).reshape(2, 32, 16, 3, 3)
    hi, lo = cc.tf32_split(weights[0])
    assert torch.equal(hl[0, :16, :5], hi) and torch.equal(hl[1, :16, :5], lo)
    assert not hl[:, 16:].any() and not hl[:, :, 5:].any()
    assert torch.equal(packed[p0.boff:p0.boff + 16], biases[0])
    # the FFMA layer (2 channels): [cin][ky][kx][cout], from a multiple of 4 floats
    assert p1.path == "ffma" and p1.woff % 4 == 0 and p1.woff >= p0.boff + 16
    assert torch.equal(packed[p1.woff:p1.boff], weights[1].permute(1, 2, 3, 0).reshape(-1))
    assert torch.equal(packed[p1.boff:], biases[1])
    assert cc._packed(weights, biases)[0] is packed  # cached
    with torch.no_grad():
        weights[1].mul_(2)  # an in-place update bumps the version: packed again
    again = cc._packed(weights, biases)[0]
    assert again is not packed and torch.equal(again[p1.woff:p1.boff], 2 * packed[p1.woff:p1.boff])


def test_build_covers_the_chain_source():
    assert "conv_chain.cu" in [p.name for p in build.sources()]
    assert len(build.SIGNATURES["pivk_conv_chain_f32"]) == 15
    assert factory.PIV_V2.conv_impl == "cudnn"
    with pytest.raises(ValueError, match="conv_impl"):
        factory.config("piv", 2, conv_impl="pallas")


# -- on the card ------------------------------------------------------------------------

# the card-only cases add batch 2 at 123x77 (off every tile edge) through the 130-channel
# three-part v1 S stack with the 5x5 last conv of level 3
GPU_CASES = {**CASES, "v1_s_level3_123x77_b2": (
    [(3, 130, 128), (3, 128, 64), (3, 64, 32), (5, 32, 2)], [64, 64, 2], (2, 123, 77), True, None)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GPU_CASES))
def test_conv_chain_kernel_matches_plain(cuda, name):
    """Tolerance 1e-5 * max|plain| (float32-accurate 3xTF32 sums in another order than cuDNN's)."""
    shapes, parts_c, (b, h, w), last_linear, _ = GPU_CASES[name]
    parts, weights, biases = _to_torch(*_chain(len(name), shapes, parts_c, b, h, w), device=cuda)
    before = cc.launches
    got = cc.conv_chain(parts, weights, biases, last_linear)
    torch.cuda.synchronize()
    assert cc.launches == before + 1
    want = cc.conv_chain_plain(parts, weights, biases, last_linear)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("version,launches", [(1, 9), (2, 6)])
def test_chain_forward_on_card_matches_cudnn_and_cpu(cuda, version, launches):
    img1, img2 = _pair(128, 128, seed=6)
    chain = piv_liteflownet(seed=0, version=version, device=cuda, conv_impl="chain")
    cc.launches = 0
    got = estimate(chain, img1, img2, tensor=True)
    torch.cuda.synchronize()
    assert cc.launches == launches
    want = estimate(piv_liteflownet(seed=0, version=version, device=cuda), img1, img2, tensor=True)
    torch.testing.assert_close(got, want, atol=MODEL_ATOL, rtol=MODEL_RTOL)
    cpu = piv_liteflownet(seed=0, version=version, device="cpu", conv_impl="chain")
    torch.testing.assert_close(got.cpu(), estimate(cpu, img1, img2, tensor=True),
                               atol=MODEL_ATOL, rtol=MODEL_RTOL)
