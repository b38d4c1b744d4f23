"""bfloat16 inference in the PyTorch port against the JAX package's bf16 path.

The JAX package runs ``estimate`` in the dtype of the model's params, and
``run.py --bf16`` casts them to bf16 (``piv_liteflownet_tpu/inference.py``,
``run.py``). The port does the same: the model after ``.to(torch.bfloat16)``,
the kernels' bf16 forms on the card, their plain versions in bf16 on the CPU.
Here, on the CPU and on the same seeded numpy inputs cast to bf16 on both
sides:

- each plain op in bf16 against its JAX function in bf16 (``correlation_xla``,
  ``ops/warp.py:backwarp``, ``rgb_warp_norm_gather``), at strides 1 and 2.
  Tolerance: one bf16 epsilon (2^-7) of the largest expected value; the two
  sides round their taps and sums at other places (the cost volume agrees
  exactly);
- bf16 ``estimate`` of piv v1 and v2 against JAX bf16 ``estimate`` at 64x96,
  with JAX params carried across by ``from_jax_params`` and then cast.
  Tolerance: 3 % of the float32 flow's max |flow|. Either side's bf16 flow
  differs from the float32 flow by about 1.2 % of it at these random weights
  (two bf16 ulps at the top of the range), and the two bf16 flows from each
  other by as much;
- the contracts: the result's dtype, no float32 tensor inside the bf16
  forward, ``run --bf16`` writes float32 ``.flo`` files, what raises
  (float16 and mixed dtypes; ``conv_impl="chain"`` in bf16 reaches the conv
  chain's bf16 form: tests/test_torch_conv_chain_bf16.py), and a bf16
  backward that reaches the backward kernels' bf16 forms (bf16 training:
  tests/test_torch_bf16_train.py);
- the bf16 launches through faked kernels: only ``pivk_*_bf16`` entry points,
  with the arguments of their float32 forms, and the cost volume's bf16 tile
  rule.

The ``gpu`` tests hold each bf16 kernel on the card to the float32 plain
version on the bf16 inputs upcast to float32, then rounded to bf16, within one
bf16 ulp of that reference plus the float32 kernel's own tolerance.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch import kernels, piv_liteflownet
from piv_liteflownet_tpu_torch.inference import estimate
from piv_liteflownet_tpu_torch.models import factory
from piv_liteflownet_tpu_torch.models.convert import from_jax_params
from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, PLAIN_OPS
from piv_liteflownet_tpu_torch.ops import conv_chain, correlation, rgb_warp, warp

BF16 = torch.bfloat16
EPS = float(torch.finfo(BF16).eps)   # 2^-7
FLOW_TOL = 0.03                      # of the float32 flow's max |flow|
CSRC = Path(correlation.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes run at once; one torch thread each keeps the cores from
    being oversubscribed (as tests/test_torch_model.py does)."""
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


def _bf16_nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(BF16)


def _f32_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _jax_f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=EPS * float(np.abs(want).max()), err_msg=what)


def _pair(h, w, seed, b=2):
    rng = np.random.default_rng(seed)
    img1 = rng.random((b, h, w, 3), dtype=np.float32)
    img2 = np.clip(img1 + 0.05 * rng.standard_normal((b, h, w, 3), dtype=np.float32), 0, 1)
    return img1, img2


# -- the plain ops in bf16 against JAX in bf16 --------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", [(2, 20, 30, 16), (1, 9, 13, 64)])
def test_corr49_plain_bf16_matches_correlation_xla(shape, stride):
    import jax.numpy as jnp

    from piv_liteflownet_tpu.ops.correlation import correlation_xla

    rng = np.random.default_rng(sum(shape) + stride)
    f1, f2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    want = _jax_f32(correlation_xla(jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16), stride))
    got = correlation.corr49_plain(_bf16_nchw(f1[:, ::stride, ::stride]), _bf16_nchw(f2[:, ::stride, ::stride]))
    assert got.dtype == BF16
    _close(_f32_nhwc(got), want, f"corr49 {shape} stride {stride}")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape,mag", [((2, 21, 31, 5), 8.0), ((1, 16, 24, 32), 30.0)])
def test_backwarp_plain_bf16_matches_jax_backwarp(shape, mag, stride):
    import jax.numpy as jnp

    from piv_liteflownet_tpu.ops.warp import backwarp as jbackwarp

    b, h, w, _ = shape
    rng = np.random.default_rng(h + stride)
    img = rng.standard_normal(shape).astype(np.float32)
    flow = rng.uniform(-mag, mag, (b, -(-h // stride), -(-w // stride), 2)).astype(np.float32)
    want = jbackwarp(jnp.asarray(img, jnp.bfloat16), jnp.asarray(flow, jnp.bfloat16), stride)
    assert want.dtype == jnp.bfloat16
    got = warp.backwarp_plain(_bf16_nchw(img), _bf16_nchw(flow), stride)
    assert got.dtype == BF16
    _close(_f32_nhwc(got), _jax_f32(want), f"backwarp {shape} stride {stride}")


@pytest.mark.parametrize("mag", [8.0, 30.0])
def test_rgb_warp_norm_plain_bf16_matches_jax_gather(mag):
    import jax.numpy as jnp

    from piv_liteflownet_tpu.ops.pallas_rgb_warp import rgb_warp_norm_gather

    rng = np.random.default_rng(int(mag))
    img1, img2 = (rng.random((2, 21, 31, 3), dtype=np.float32) for _ in range(2))
    flow = rng.uniform(-mag, mag, (2, 21, 31, 2)).astype(np.float32)
    want = rgb_warp_norm_gather(*(jnp.asarray(a, jnp.bfloat16) for a in (img1, img2, flow)))
    assert want.dtype == jnp.bfloat16
    got = rgb_warp.rgb_warp_norm_plain(*(_bf16_nchw(a) for a in (img1, img2, flow)))
    assert got.dtype == BF16
    _close(_f32_nhwc(got), _jax_f32(want), f"rgb_warp_norm |flow|<={mag}")


# -- the slice: bf16 estimate against JAX bf16 estimate ----------------------------------

@pytest.fixture(scope="module")
def jax_bf16_estimates():
    """version -> (JAX params as numpy, inputs, JAX bf16 estimate), piv at 64x96 b2."""
    import jax
    import jax.numpy as jnp

    from piv_liteflownet_tpu.inference import estimate as jestimate
    from piv_liteflownet_tpu.models import factory as jfactory

    out = {}
    for version in (1, 2):
        jmodel = jfactory.piv_liteflownet(version=version, seed=3)
        jbf16 = jfactory.Model(cfg=jmodel.cfg, params=jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                                                    jmodel.params))
        img1, img2 = _pair(64, 96, seed=version)
        want = jestimate(jbf16, img1, img2)
        assert want.dtype == jnp.bfloat16
        out[version] = ({k: np.asarray(v) for k, v in jmodel.params.items()}, (img1, img2), _jax_f32(want))
    return out


def _ported(params, version, dtype=torch.float32):
    cfg = factory.config("piv", version)
    return piv_liteflownet(from_jax_params(cfg, params), version=version, device="cpu").to(dtype)


@pytest.mark.parametrize("version", [1, 2])
def test_bf16_estimate_matches_jax_bf16(jax_bf16_estimates, version):
    params, (img1, img2), want = jax_bf16_estimates[version]
    f32 = estimate(_ported(params, version), img1, img2).numpy()
    got = estimate(_ported(params, version, BF16), img1, img2)
    assert got.dtype == BF16 and got.shape == (2, 64, 96, 2)
    tol = FLOW_TOL * float(np.abs(f32).max())
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol, f"port bf16 vs JAX bf16: {err:.3e} > {tol:.3e}"
    # both bf16 flows stay in the same band around the float32 flow
    assert float(np.abs(got.float().numpy() - f32).max()) <= tol
    assert float(np.abs(want - f32).max()) <= tol


def test_bf16_estimate_result_forms():
    model = piv_liteflownet(version=1, seed=0, device="cpu").to(BF16)
    img1, img2 = _pair(40, 50, seed=5, b=1)
    batch = estimate(model, img1, img2)
    assert batch.dtype == BF16 and batch.shape == (1, 40, 50, 2)
    single = estimate(model, img1[0], img2[0])
    assert isinstance(single, np.ndarray) and single.dtype == np.float32
    np.testing.assert_array_equal(single, batch[0].float().numpy())
    # the float32 array holds bf16 values exactly
    np.testing.assert_array_equal(torch.from_numpy(single).to(BF16).float().numpy(), single)
    tensor = estimate(model, torch.from_numpy(img1[0]), torch.from_numpy(img2[0]), tensor=True)
    assert tensor.dtype == BF16 and tensor.shape == (1, 40, 50, 2)


@pytest.mark.parametrize("version", [1, 2])
def test_bf16_forward_keeps_bf16_throughout(version):
    """Every module's output in the bf16 eval forward is bf16: no float32 tensor leaks in."""
    model = piv_liteflownet(version=version, seed=0, device="cpu").to(BF16)
    seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out, name=name: seen.append(
        (name, [t.dtype for t in (out if isinstance(out, (list, tuple)) else [out])])))
        for name, m in model.named_modules()]
    img1, img2 = _pair(64, 64, seed=6, b=1)
    try:
        estimate(model, img1, img2)
    finally:
        for h in hooks:
            h.remove()
    assert seen and all(d == BF16 for _, dtypes in seen for d in dtypes), \
        [s for s in seen if any(d != BF16 for d in s[1])][:5]


def test_run_cli_bf16_writes_float32_flo(tmp_path):
    from PIL import Image

    from piv_liteflownet_tpu_torch import run as port_run
    from piv_liteflownet_tpu_torch.utils.flow_io import read_flow

    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    rng = np.random.default_rng(0)
    frames = []
    for tag in ("img1", "img2"):
        arr = (rng.random((32, 48, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(indir / f"p00_{tag}.png")
        frames.append(arr.astype(np.float32) / 255.0)
    port_run.main(["--model", "piv", "-p", "-i", str(indir), "-o", str(outdir), "--cpu", "--bf16"])
    flo = outdir / "PIV-LiteFlowNet-en" / "in" / "flow" / "p00_img1_out.flo"
    assert flo.stat().st_size == 12 + 4 * 32 * 48 * 2  # float32 bands
    flow = read_flow(str(flo))
    model = piv_liteflownet(version=1, seed=0, device="cpu").to(BF16)
    np.testing.assert_array_equal(flow, estimate(model, frames[0], frames[1]))
    assert "bf16: True" in (flo.parents[1] / "args.txt").read_text()


# -- what raises -------------------------------------------------------------------------

def test_bf16_with_the_conv_chain_raises(monkeypatch):
    """A bf16 estimate with ``conv_impl="chain"`` reaches the chain's bf16 entry point (faked), and
    a float16 chain raises. (The name is from when the chain had no bf16 form and this estimate
    raised; the test is kept under it, its contract changed.)"""
    z = torch.zeros(1, 4, 8, 8, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv_chain.conv_chain([z], [torch.zeros(2, 4, 3, 3, dtype=torch.float16)],
                              [torch.zeros(2, dtype=torch.float16)])
    _fake_kernels(monkeypatch)
    calls = []

    def chain_launch(parts, weights, biases, last_linear, out):
        monkeypatch.setattr(kernels, "launch", lambda name, *a: calls.append((name, out.dtype)))
        real_chain_launch(parts, weights, biases, last_linear, out)
        out.copy_(conv_chain.conv_chain_plain(parts, weights, biases, last_linear))

    real_chain_launch = conv_chain._launch
    monkeypatch.setattr(conv_chain, "_launch", chain_launch)
    model = piv_liteflownet(version=1, seed=0, device="cpu", conv_impl="chain").to(BF16)
    img1, img2 = _pair(64, 64, seed=7, b=1)
    flow = estimate(model, img1, img2, tensor=True)
    assert flow.dtype == BF16 and bool(torch.isfinite(flow.float()).all())
    assert calls == [("pivk_conv_chain_bf16", BF16)] * 6  # the M, S and R stacks at 32 and 64


def test_mixed_dtypes_raise():
    f32, b16 = torch.zeros(1, 4, 8, 8), torch.zeros(1, 4, 8, 8, dtype=BF16)
    with pytest.raises(TypeError, match="different dtypes"):
        correlation.corr49(f32, b16)
    with pytest.raises(TypeError, match="different dtypes"):
        warp.backwarp(b16, torch.zeros(1, 2, 8, 8))
    img = torch.zeros(1, 3, 8, 8, dtype=BF16)
    with pytest.raises(TypeError, match="different dtypes"):
        rgb_warp.rgb_warp_norm(img, img, torch.zeros(1, 2, 8, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        correlation.corr49(f32.half(), f32.half())


def _fake_kernels(monkeypatch):
    """Route every op through its kernel path on the CPU: ``on_cuda`` says yes and each ``_launch``
    runs the plain version and records the dtype it was given."""
    seen = []

    def fake(plain):
        def launch(*args):
            *ins, out = args
            seen.append(out.dtype)
            out.copy_(plain(*ins))
        return launch

    monkeypatch.setattr(kernels, "on_cuda", lambda op, *tensors: True)
    monkeypatch.setattr(correlation, "_launch", fake(correlation.corr49_plain))
    monkeypatch.setattr(warp, "_launch", fake(warp.backwarp_plain))
    monkeypatch.setattr(rgb_warp, "_launch", fake(rgb_warp.rgb_warp_norm_plain))
    for mod in (correlation, warp, rgb_warp):
        monkeypatch.setattr(mod, "launches", 0)
        monkeypatch.setattr(mod, "bf16_launches", 0)
    return seen


def test_bf16_backward_raises(monkeypatch):
    """The bf16 backward of ``corr49`` and ``backwarp`` reaches their ``_bf16`` entry points
    (faked) and raises nothing. (The name is from when the backward kernels had no bf16 forms
    and this backward raised; the test is kept under it, its contract changed.)"""
    _fake_kernels(monkeypatch)
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda name, *a: calls.append(name))
    f1 = torch.randn(1, 4, 8, 8, dtype=BF16, requires_grad=True)
    f2 = torch.randn(1, 4, 8, 8, dtype=BF16, requires_grad=True)
    correlation.corr49(f1, f2).sum().backward()
    flow = torch.zeros(1, 2, 8, 8, dtype=BF16, requires_grad=True)
    warp.backwarp(f1, flow).sum().backward()
    assert calls == ["pivk_corr49_bwd_bf16", "pivk_backwarp_bwd_bf16"], "the bf16 backward missed its kernels"
    assert f1.grad.dtype == f2.grad.dtype == flow.grad.dtype == BF16


@pytest.mark.parametrize("version,counts", [(1, (6, 11, 6)), (2, (5, 9, 5))])
def test_bf16_estimate_launches_only_bf16_forms(monkeypatch, version, counts):
    seen = _fake_kernels(monkeypatch)
    model = piv_liteflownet(version=version, seed=0, device="cpu").to(BF16)
    img1, img2 = _pair(64, 96, seed=8, b=1)
    got = estimate(model, img1, img2, tensor=True)
    mods = (correlation, warp, rgb_warp)
    assert tuple(m.bf16_launches for m in mods) == counts
    assert tuple(m.launches for m in mods) == (0, 0, 0)
    assert seen and set(seen) == {BF16}
    want = estimate(model, img1, img2, tensor=True, ops=PLAIN_OPS)
    assert torch.equal(got, want)


def test_bf16_launch_arguments(monkeypatch):
    """Each op's ``_launch`` calls the ``_bf16`` entry point with the arguments of the f32 form (the
    backwarp's with its counter of tiles that gathered directly after its output)."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a))
    for dtype in (torch.float32, BF16):
        f1, f2 = torch.zeros(2, 3, 5, 8, dtype=dtype), torch.zeros(2, 3, 5, 8, dtype=dtype)
        out = torch.zeros(2, 49, 5, 8, dtype=dtype)
        correlation._launch(f1, f2, out)
        img, flow = torch.zeros(2, 3, 9, 8, dtype=dtype), torch.zeros(2, 2, 5, 4, dtype=dtype)
        wout = torch.zeros(2, 3, 5, 4, dtype=dtype)
        warp._launch(img, flow, 2, wout)
        i1, fl = torch.zeros(1, 3, 6, 7, dtype=dtype), torch.zeros(1, 2, 6, 7, dtype=dtype)
        nout = torch.zeros(1, 1, 6, 7, dtype=dtype)
        rgb_warp._launch(i1, i1, fl, nout)
    f32_calls, bf16_calls = calls[:3], calls[3:]
    assert [c[0] for c in bf16_calls] == ["pivk_corr49_bf16", "pivk_backwarp_bf16", "pivk_rgb_warp_norm_bf16"]
    assert [c[0] for c in f32_calls] == ["pivk_corr49_f32", "pivk_backwarp_f32", "pivk_rgb_warp_norm_f32"]
    counter = correlation.edge_tile_counter(torch.device("cpu"))
    corr_args, warp_args, rgb_args = (c[3:] for c in bf16_calls)
    assert corr_args[:4] == (f1.data_ptr(), f2.data_ptr(), out.data_ptr(), counter.data_ptr())
    assert corr_args[4:] == (2, 3, 5, 8)
    assert warp_args == (img.data_ptr(), flow.data_ptr(), wout.data_ptr(),
                         warp.direct_tile_counter(torch.device("cpu")).data_ptr(), 2, 3, 9, 8, 5, 4, 2)
    assert f32_calls[1][6:] == warp_args[4:]  # the f32 form: no counter
    assert rgb_args == (i1.data_ptr(), i1.data_ptr(), fl.data_ptr(), nout.data_ptr(), 1, 6, 7)
    # the same shapes of arguments as the float32 forms, which the C signatures share
    from piv_liteflownet_tpu_torch.kernels import build

    for f32_call, bf16_call in zip(f32_calls, bf16_calls):
        sig32, sig16 = build.SIGNATURES[f32_call[0]], build.SIGNATURES[bf16_call[0]]
        if bf16_call[0] == "pivk_backwarp_bf16":
            assert len(bf16_call) == len(f32_call) + 1 and sig16 == sig32[:3] + (sig32[0],) + sig32[3:]
        else:
            assert len(f32_call) == len(bf16_call) and sig16 == sig32
    # the cost volume's bf16 form has a source of its own; the others share their float32 form's
    for name, source in (("pivk_corr49_bf16", "corr49_bf16.cu"), ("pivk_backwarp_bf16", "backwarp.cu"),
                         ("pivk_rgb_warp_norm_bf16", "rgb_warp_norm.cu")):
        assert f'extern "C" int {name}(' in (CSRC / source).read_text()


# -- the cost volume's bf16 tile rule ------------------------------------------------------

def test_bf16_tile_rule():
    for w in (8, 16, 512):
        assert not correlation.tile_plan(1, 8, w, dtype=BF16).edge
    for w in (4, 12, 53):
        assert correlation.tile_plan(1, 8, w, dtype=BF16).edge  # 4 | w is not enough for bf16
    assert not correlation.tile_plan(1, 8, 12).edge
    aligned = torch.zeros(1, 2, 8, 16, dtype=BF16)
    assert not correlation.uses_edge_path(aligned, aligned)
    assert correlation.uses_edge_path(torch.zeros(1, 2, 8, 12, dtype=BF16), torch.zeros(1, 2, 8, 12, dtype=BF16))
    shifted = torch.zeros(1 + 2 * 128, dtype=BF16)[1:].view(1, 2, 8, 16)  # 2 bytes off
    assert correlation.uses_edge_path(shifted, aligned)
    # the backward has a bf16 form too, with the same width rule
    assert not correlation.tile_plan(1, 8, 16, backward=True, dtype=BF16).edge
    assert correlation.tile_plan(1, 8, 12, backward=True, dtype=BF16).edge
    # the bf16 tiles start at x = -4, so that their windows lie on the 16-byte grid
    assert correlation.tile_plan(1, 8, 512, dtype=BF16).x0[:2] == [-4, 28]
    assert len(correlation.tile_plan(1, 8, 512, dtype=BF16).x0) == 17
    assert correlation.tile_plan(1, 8, 512).x0[:2] == [0, 32]
    # the shared memory each form's source states (the bf16 form has its own, csrc/corr49_bf16.cu)
    stated32 = re.search(r"constexpr int SMEM = .*// ([\d,]+) bytes in f32", (CSRC / "corr49.cu").read_text())
    stated16 = re.search(r"constexpr int SMEM = .*// ([\d,]+) bytes", (CSRC / "corr49_bf16.cu").read_text())
    assert [int(m.group(1).replace(",", "")) for m in (stated32, stated16)] == [
        correlation.smem_bytes(False), correlation.smem_bytes(False, BF16)]
    assert correlation.smem_bytes(False, BF16) <= correlation.SMEM_LIMIT


def test_bf16_staging_replayed_matches_plain():
    """The bf16 forward's windows: tiles of 32x8 from x = -4, each staging columns x0-4 .. x0+35 of
    f2 (rows y0-3 ..) and of f1 (rows y0 ..); output pixel p of the tile meets f1's box column p+4
    and f2's columns p+4+dx. Replayed in float64 on bf16 values against the plain version in
    float64, then rounded to bf16 as the kernel rounds its f32 sums."""
    rng = np.random.default_rng(9)
    b, c, h, w = 1, 3, 10, 40
    f1, f2 = (torch.from_numpy(rng.standard_normal((b, c, h, w))).to(BF16).double() for _ in range(2))
    tx, ty = 32, 8
    ny, nx = -(-h // ty), -(-(w + 4) // tx)
    assert nx == len(correlation.tile_plan(b, h, w, dtype=BF16).x0)
    f2p = torch.nn.functional.pad(f2, (8, nx * tx - w + 8, 3, ny * ty - h + 3))  # column 0: x = -8
    f1p = torch.nn.functional.pad(f1, (8, nx * tx - w + 8, 0, ny * ty - h))
    out = torch.zeros(b, 49, ny * ty, nx * tx, dtype=torch.float64)  # column 0: x = -4
    for by in range(ny):
        for bx in range(nx):
            box2 = f2p[:, :, by * ty:by * ty + ty + 6, bx * tx:bx * tx + tx + 8]  # x0-4 .. x0+35
            box1 = f1p[:, :, by * ty:by * ty + ty, bx * tx:bx * tx + tx + 8]
            assert box2.shape[-1] == 40
            for yy in range(ty):
                for p in range(tx):
                    a = box1[:, :, yy, p + 4]
                    for dy in range(7):
                        for dx in range(7):
                            out[:, dy * 7 + dx, by * ty + yy, bx * tx + p] = (
                                (a * box2[:, :, yy + dy, p + 4 + dx - 3]).sum(1) * (1.0 / c))
    want = correlation.corr49_plain(f1, f2)
    torch.testing.assert_close(out[:, :, :h, 4:4 + w].to(BF16), want.to(BF16), rtol=0, atol=0)


# -- the backwarp's bf16 tile rule ---------------------------------------------------------

def _staged_flow(kind, b, ho, wo, stride, seed):
    if kind == "zero":
        return np.zeros((b, 2, ho, wo), np.float32)
    return np.random.default_rng(seed).uniform(-kind, kind, (b, 2, ho, wo)).astype(np.float32)


@pytest.mark.parametrize("b,c,h,w,stride,kind,aligned", [
    (2, 5, 40, 64, 1, "zero", True), (2, 7, 40, 64, 2, 3.0, True), (1, 3, 64, 96, 1, 8.0, True),
    (1, 3, 64, 96, 2, 8.0, True), (1, 3, 64, 96, 1, 30.0, True), (2, 5, 37, 53, 1, 3.0, True),
    (1, 3, 40, 64, 1, 3.0, False), (1, 2, 16, 248, 2, 60.0, True)])
def test_backwarp_bf16_staged_tiles_replay_the_kernel(b, c, h, w, stride, kind, aligned):
    """``ops/warp.py:staged_tiles`` against the taps, and ``csrc/backwarp.cu``'s staged path replayed
    with numpy: each staged tile's footprint rows copied from x rounded down to 8, in 16-byte chunks
    (8 values), at most ``STAGED_CHUNKS`` a channel, and each pixel's taps read there at
    ``(y - y0) * 8 * chunks_a_row + x - x0``; every output equals the plain backwarp's."""
    ho, wo = warp.out_hw(h, w, stride)
    flow = _staged_flow(kind, b, ho, wo, stride, seed=h + w + stride)
    img = torch.from_numpy(np.random.default_rng(w).standard_normal((b, c, h, w)).astype(np.float32))
    img = img.to(BF16).float().numpy()  # bf16 values, as the kernel stages them
    want = warp.backwarp_plain(torch.from_numpy(img), torch.from_numpy(flow), stride).numpy()
    direct = warp.staged_tiles(torch.from_numpy(flow), h, w, stride, aligned=aligned).numpy()
    tw, th = warp.STAGED_TILE
    assert direct.shape == (b, -(-ho // th), -(-wo // tw))
    x = np.arange(wo, dtype=np.float32)[None, None, :] * np.float32(stride) + flow[:, 0]
    y = np.arange(ho, dtype=np.float32)[None, :, None] * np.float32(stride) + flow[:, 1]
    x0, y0 = np.floor(x), np.floor(y)
    wx, wy = x - x0, y - y0
    got = np.full((b, c, ho, wo), np.nan, np.float32)
    for bi in range(b):
        for ty in range(direct.shape[1]):
            for tx in range(direct.shape[2]):
                sl = (bi, slice(ty * th, (ty + 1) * th), slice(tx * tw, (tx + 1) * tw))
                taps = [(x0[sl] + (k & 1), y0[sl] + (k >> 1)) for k in range(4)]
                inside = [(cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1) for cx, cy in taps]
                xs = np.concatenate([cx[ok] for (cx, _), ok in zip(taps, inside)])
                ys = np.concatenate([cy[ok] for (_, cy), ok in zip(taps, inside)])
                if not xs.size:
                    chunks = 0
                else:
                    fx0, fy0 = int(xs.min()) // 8 * 8, int(ys.min())
                    ncw = (int(xs.max()) - fx0) // 8 + 1
                    chunks = ncw * (int(ys.max()) - fy0 + 1)
                assert bool(direct[bi, ty, tx]) == (w % 8 != 0 or not aligned or chunks > warp.STAGED_CHUNKS)
                if direct[bi, ty, tx] or not xs.size:
                    got[(bi, slice(None)) + sl[1:]] = want[(bi, slice(None)) + sl[1:]] if xs.size else 0.0
                    continue
                stage = np.zeros((c, 8 * warp.STAGED_CHUNKS), np.float32)  # the channels' staged rows
                rows = int(ys.max()) - fy0 + 1
                cols = np.minimum(fx0 + np.arange(8 * ncw), w - 1)
                stage[:, :8 * ncw * rows] = img[bi][:, fy0:fy0 + rows][:, :, cols].reshape(c, -1)
                acc = np.zeros((c,) + x0[sl].shape, np.float32)
                for k, ((cx, cy), ok) in enumerate(zip(taps, inside)):
                    off = ((cy - fy0) * 8 * ncw + cx - fx0).astype(np.int64)
                    wgt = ((wx[sl] if k & 1 else 1 - wx[sl]) * (wy[sl] if k >> 1 else 1 - wy[sl])).astype(np.float32)
                    vals = np.where(ok, stage[:, np.where(ok, off, 0)], 0.0)
                    acc = acc + np.where(ok, wgt * vals, 0.0).astype(np.float32)
                got[(bi, slice(None)) + sl[1:]] = acc
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert warp.staged_tiles(torch.from_numpy(flow), h, w, stride, aligned=aligned).dtype == torch.bool


def test_backwarp_bf16_staged_constants_match_the_source():
    src = (CSRC / "backwarp.cu").read_text()
    tw, th = map(int, re.search(r"constexpr int TW = (\d+), TH = (\d+);", src).groups())
    chunks = int(re.search(r"constexpr int CHUNKS = (\d+);", src).group(1))
    assert ((tw, th), chunks) == (warp.STAGED_TILE, warp.STAGED_CHUNKS)
    assert "W % 8 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0" in src
    assert warp.direct_tile_counter(torch.device("cpu")) is warp.direct_tile_counter(torch.device("cpu"))


# -- on the card -------------------------------------------------------------------------

def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |t| (t a bf16 reference, as float32)."""
    _, e = torch.frexp(t.abs())
    return torch.ldexp(torch.ones_like(t), e - 8)


def _hold_to_reference(got: torch.Tensor, f32_plain: torch.Tensor, f32_tol: float, what: str) -> None:
    """|got - ref| <= ulp(ref) + f32_tol elementwise, ref the float32 plain result rounded to bf16."""
    assert got.dtype == BF16, what
    ref = f32_plain.to(BF16).float()
    err = (got.float() - ref).abs()
    bad = err > _bf16_ulp(ref) + f32_tol
    assert not bool(bad.any()), f"{what}: {int(bad.sum())} values off, max err {float(err.max()):.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w", [(1, 64, 512, 512), (1, 192, 8, 8), (2, 3, 37, 53), (1, 4, 3, 12),
                                     (1, 1, 1, 1)])
def test_corr49_bf16_kernel_matches_rounded_f32_plain(cuda, b, c, h, w):
    g = torch.Generator(device=cuda).manual_seed(c + h)
    f1, f2 = (torch.randn(b, c, h, w, device=cuda, generator=g).to(BF16) for _ in range(2))
    counter = correlation.edge_tile_counter(cuda)
    counter.zero_()
    before = correlation.bf16_launches
    got = correlation.corr49(f1, f2)
    torch.cuda.synchronize()
    assert correlation.bf16_launches == before + 1
    plan = correlation.tile_plan(b, h, w, dtype=BF16)
    assert int(counter.item()) == (plan.n_tiles if plan.edge else 0)
    a, bb = f1.float(), f2.float()
    _hold_to_reference(got, correlation.corr49_plain(a, bb), 1e-5 * float((a * bb).abs().mean()),
                       f"corr49 bf16 [{b},{c},{h},{w}]")


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w,stride,mag", [(1, 64, 64, 96, 1, 8.0), (2, 5, 37, 53, 1, 30.0),
                                                 (1, 64, 64, 96, 2, 8.0), (2, 7, 37, 53, 2, 30.0),
                                                 (2, 33, 40, 64, 1, 3.0), (2, 7, 40, 64, 2, 3.0),
                                                 (2, 5, 41, 67, 1, 4.0), (1, 33, 64, 96, 1, 30.0),
                                                 (2, 33, 40, 64, 2, 30.0)])
def test_backwarp_bf16_kernel_matches_rounded_f32_plain(cuda, b, c, h, w, stride, mag):
    g = torch.Generator(device=cuda).manual_seed(c + stride)
    img = torch.randn(b, c, h, w, device=cuda, generator=g).to(BF16)
    ho, wo = warp.out_hw(h, w, stride)
    flow = ((torch.rand(b, 2, ho, wo, device=cuda, generator=g) * 2 - 1) * mag).to(BF16)
    counter = warp.direct_tile_counter(cuda)
    counter.zero_()
    got = warp.backwarp(img, flow, stride)
    torch.cuda.synchronize()
    assert int(counter.item()) == int(warp.staged_tiles(flow.float(), h, w, stride).sum())
    _hold_to_reference(got, warp.backwarp_plain(img.float(), flow.float(), stride), 1e-5,
                       f"backwarp bf16 [{b},{c},{h},{w}] stride {stride}")


@pytest.mark.gpu
def test_backwarp_bf16_off_16_bytes_gathers_every_tile(cuda):
    b, c, h, w = 1, 5, 40, 64
    base = torch.randn(b * c * h * w + 1, device=cuda).to(BF16)
    img = base[1:].view(b, c, h, w)
    flow = (torch.rand(b, 2, h, w, device=cuda) * 6 - 3).to(BF16)
    counter = warp.direct_tile_counter(cuda)
    counter.zero_()
    got = warp.backwarp(img, flow)
    torch.cuda.synchronize()
    rule = warp.staged_tiles(flow.float(), h, w, 1, aligned=False)
    assert bool(rule.all()) and int(counter.item()) == rule.numel()
    _hold_to_reference(got, warp.backwarp_plain(img.float(), flow.float()), 1e-5, "backwarp bf16 2 bytes off")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,mag", [(1, 256, 256, 8.0), (2, 37, 53, 30.0)])
def test_rgb_warp_norm_bf16_kernel_matches_rounded_f32_plain(cuda, b, h, w, mag):
    g = torch.Generator(device=cuda).manual_seed(h)
    img1, img2 = (torch.rand(b, 3, h, w, device=cuda, generator=g).to(BF16) for _ in range(2))
    flow = ((torch.rand(b, 2, h, w, device=cuda, generator=g) * 2 - 1) * mag).to(BF16)
    got = rgb_warp.rgb_warp_norm(img1, img2, flow)
    torch.cuda.synchronize()
    _hold_to_reference(got, rgb_warp.rgb_warp_norm_plain(img1.float(), img2.float(), flow.float()), 1e-5,
                       f"rgb_warp_norm bf16 [{b},3,{h},{w}]")


@pytest.mark.gpu
def test_bf16_estimate_on_card_launches_bf16_forms_and_tracks_f32(cuda):
    model = piv_liteflownet(version=1, seed=0, device=cuda)
    img1, img2 = _pair(128, 160, seed=10, b=1)
    t1, t2 = torch.from_numpy(img1).to(cuda), torch.from_numpy(img2).to(cuda)
    f32 = estimate(model, t1, t2)
    mods = (correlation, warp, rgb_warp)
    for m in mods:
        m.launches = m.bf16_launches = 0
    got = estimate(model.to(BF16), t1, t2, ops=KERNEL_OPS)
    torch.cuda.synchronize()
    assert tuple(m.bf16_launches for m in mods) == (6, 11, 6)
    assert tuple(m.launches for m in mods) == (0, 0, 0)
    assert got.dtype == BF16
    assert float((got.float() - f32).abs().max()) <= FLOW_TOL * float(f32.abs().max())
    cpu = estimate(piv_liteflownet(version=1, seed=0, device="cpu").to(BF16), img1, img2)
    assert float((got.float().cpu() - cpu.float()).abs().max()) <= FLOW_TOL * float(f32.abs().max())

