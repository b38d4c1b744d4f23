"""The rgb warp-norm op of the PyTorch port (``ops/rgb_warp.py``, kernel ``csrc/rgb_warp_norm.cu``).

On the CPU: the plain version in float32 and bf16 against JAX's ``rgb_warp_norm_gather`` on flows
that leave the map and at odd widths; NaN, huge and infinite sample points read as outside the map;
the kernel's rule of pixels a lane kept in step with its source; the arguments ``_launch`` hands the
C entry points; the evalset read as JAX's ``evaluate.py`` reads it; and the port's float32
``estimate`` with the trained v1 weights (``work/synth_run/params_final.npz``) held to JAX's on a
128x128 crop of an evalset pair. On the card (``gpu``): both kernel forms, at one and two pixels a
lane, against the plain version, and a second launch bit-equal to the first.

Inputs are made with numpy from a seed. JAX is imported inside the tests, so the ``gpu`` tests also
collect on a machine without it (run there with ``--noconftest``).

Tolerances: atol 1e-5 in float32 (the two sides take the same taps, summed in another order); the
bf16 plain version within 2^-7 x max|JAX| of JAX's bf16 function (its rounding steps, as
``tests/test_torch_bf16.py`` holds it); on the card the bf16 kernel within one bf16 ulp of the
float32 plain version on the same values, rounded, plus 1e-5; ``estimate`` within 1e-3 px of JAX's
(float32 convs on both sides, TF32 off).
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch import kernels
from piv_liteflownet_tpu_torch.kernels import build
from piv_liteflownet_tpu_torch.ops import rgb_warp

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS_V1 = ROOT / "work" / "synth_run" / "params_final.npz"
EVALSET = ROOT / "work" / "synth_run" / "evalset"
ATOL = 1e-5
BF16 = torch.bfloat16
EPS = float(torch.finfo(BF16).eps)  # 2^-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread each."""
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


def _flow(kind, b, h, w, seed):
    """A flow ``[b,h,w,2]`` (NHWC, float32) of ``kind``: "smooth" (a shift and waves of a few pixels),
    "steep" (uniform up to 30 px), "shift" (the frame sampled 0.6 of its width right, 0.4 of its height
    up: most taps off the map), "nan" (NaN, huge and infinite values among 3 px ones), or a number:
    uniform up to that many pixels."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    if kind == "smooth":
        u = 1.5 + 3.0 * np.sin(2 * np.pi * ys / 64) * np.cos(2 * np.pi * xs / 96)
        v = -0.5 + 2.0 * np.cos(2 * np.pi * xs / 75)
        flow = np.stack([u, v], -1)[None].repeat(b, 0)
    elif kind == "shift":
        flow = np.broadcast_to(np.array([0.6 * w, -0.4 * h], np.float32), (b, h, w, 2))
    else:
        mag = 30.0 if kind == "steep" else 3.0 if kind == "nan" else kind
        flow = rng.uniform(-mag, mag, (b, h, w, 2))
        if kind == "nan":
            flat = flow.reshape(-1)
            flat[::7], flat[3::11], flat[5::13] = np.nan, 3e9, -np.inf
    return np.ascontiguousarray(flow, dtype=np.float32)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


# -- the plain version against JAX -----------------------------------------------------------

@pytest.mark.parametrize("kind,shape", [("shift", (2, 20, 30)), ("steep", (1, 37, 53)), (8.0, (2, 21, 31))])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_plain_matches_jax_gather(kind, shape, dtype):
    import jax.numpy as jnp

    from piv_liteflownet_tpu.ops.pallas_rgb_warp import rgb_warp_norm_gather

    b, h, w = shape
    rng = np.random.default_rng(h * w)
    img1, img2 = (rng.random((b, h, w, 3), dtype=np.float32) for _ in range(2))
    flow = _flow(kind, b, h, w, seed=h)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(rgb_warp_norm_gather(*(jnp.asarray(a, jdtype) for a in (img1, img2, flow)))).astype(np.float32)
    got = rgb_warp.rgb_warp_norm_plain(*(_nchw(a).to(dtype) for a in (img1, img2, flow)))
    assert got.dtype == dtype
    atol = ATOL if dtype == torch.float32 else EPS * float(np.abs(want).max())
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_plain_reads_nan_and_huge_sample_points_as_outside(dtype):
    """A NaN, huge or infinite sample point has no tap inside the map: the warp reads zeros there, so
    the norm is |img1| (as the kernels read it). The plain version used to raise on a NaN one: the
    NaN coordinate became an out-of-range gather index."""
    rng = np.random.default_rng(5)
    img1, img2 = (rng.random((1, 9, 12, 3), dtype=np.float32) for _ in range(2))
    flow = np.zeros((1, 9, 12, 2), np.float32)
    bad = {(2, 3, 0): np.nan, (4, 4, 1): np.nan, (6, 1, 0): 3e9, (7, 8, 1): -np.inf, (8, 2, 0): np.inf}
    for (y, x, k), value in bad.items():
        flow[0, y, x, k] = value
    got = _nhwc(rgb_warp.rgb_warp_norm_plain(*(_nchw(a).to(dtype) for a in (img1, img2, flow))))[0, ..., 0]
    norm1 = np.sqrt((_nhwc(_nchw(img1).to(dtype))[0] ** 2).sum(-1))
    for y, x, _ in bad:
        np.testing.assert_allclose(got[y, x], norm1[y, x], rtol=EPS if dtype == BF16 else 1e-6)
    assert np.isfinite(got).all()
    # elsewhere the zero flow samples img2 itself
    diff = np.sqrt(((_nhwc(_nchw(img1).to(dtype))[0] - _nhwc(_nchw(img2).to(dtype))[0]) ** 2).sum(-1))
    np.testing.assert_allclose(got[0], diff[0], rtol=EPS if dtype == BF16 else 1e-6)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_backwarp_plain_reads_nan_sample_points_as_zeros(dtype, stride):
    """The plain feature warp under the norm (``ops/warp.py:backwarp_plain``) at both strides: a NaN,
    huge or infinite sample point reads zeros in every channel; the other pixels are those of the
    same flow with the bad points replaced by a point far outside."""
    from piv_liteflownet_tpu_torch.ops.warp import backwarp_plain

    rng = np.random.default_rng(stride)
    img = torch.from_numpy(rng.standard_normal((2, 5, 12, 16), dtype=np.float32)).to(dtype)
    flow = torch.from_numpy(rng.uniform(-3, 3, (2, 2, 12 // stride, 16 // stride)).astype(np.float32))
    bad = torch.zeros_like(flow[:, :1], dtype=torch.bool)
    bad[0, 0, 1, 2] = bad[1, 0, 3, 0] = bad[0, 0, 5, 7] = True
    flow[0, 0, 1, 2], flow[1, 1, 3, 0], flow[0, 0, 5, 7] = float("nan"), 3e9, -float("inf")
    got = backwarp_plain(img, flow.to(dtype), stride)
    far = torch.where(bad, torch.tensor(1e4), flow)
    want = backwarp_plain(img, far.to(dtype), stride)
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, want) and not got[bad.expand_as(got)].any()


# -- the launch --------------------------------------------------------------------------------

def test_pixels_a_lane_is_the_kernel_rule():
    """``pixels_a_lane`` uses the source's threshold: two pixels a lane from ``LANES2_MIN_PIXELS``."""
    src = (ROOT / "piv_liteflownet_tpu_torch" / "csrc" / "rgb_warp_norm.cu").read_text()
    assert "constexpr long long LANES2_MIN_PIXELS = 1 << 17;" in src
    assert rgb_warp.LANES2_MIN_PIXELS == 1 << 17
    assert rgb_warp.pixels_a_lane(1, 256, 512) == rgb_warp.pixels_a_lane(8, 256, 256) == 2
    assert rgb_warp.pixels_a_lane(1, 256, 511) == rgb_warp.pixels_a_lane(2, 32, 32) == 1


def test_breakdown_groups_the_kernel():
    """``breakdown`` counts both forms and both pixel counts a lane as the ``rgb_warp_norm`` group."""
    from piv_liteflownet_tpu_torch.breakdown import group_of

    for form in ("float", "__nv_bfloat16"):
        for j in (1, 2):
            name = f"void (anonymous namespace)::rgb_warp_norm_lanes_kernel<{form}, {j}>(...)"
            assert group_of(name) == "rgb_warp_norm"


def test_launch_arguments(monkeypatch):
    """Both forms get the three pointers, the output and the sizes, as many as their C signature
    (less the device and stream)."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a))
    tensors = {}
    for dtype in (torch.float32, BF16):
        img1, img2 = torch.zeros(2, 3, 6, 7, dtype=dtype), torch.zeros(2, 3, 6, 7, dtype=dtype)
        flow, out = torch.zeros(2, 2, 6, 7, dtype=dtype), torch.zeros(2, 1, 6, 7, dtype=dtype)
        rgb_warp._launch(img1, img2, flow, out)
        tensors[dtype] = (img1, img2, flow, out)
    assert [c[:2] for c in calls] == [("pivk_rgb_warp_norm_f32", "rgb_warp_norm"),
                                      ("pivk_rgb_warp_norm_bf16", "rgb_warp_norm")]
    for call, (img1, img2, flow, out) in zip(calls, tensors.values()):
        assert call[3:] == (img1.data_ptr(), img2.data_ptr(), flow.data_ptr(), out.data_ptr(), 2, 6, 7)
        assert len(build.SIGNATURES[call[0]]) == len(call) - 3 + 2  # + device and stream


# -- trained weights ---------------------------------------------------------------------------

def test_evalset_reads_as_jax_evaluate():
    """``chip_smoke.read_evalset`` gives the frames and flows JAX's ``InferenceEval`` gives
    ``evaluate.py``, in its order, and ``pair_epes`` its per-pair mean EPE."""
    import chip_smoke
    from piv_liteflownet_tpu.data.datasets import InferenceEval

    names, im1, im2, gt = chip_smoke.read_evalset(EVALSET)
    ds = InferenceEval(str(EVALSET))
    assert len(ds) == len(names) == 4
    rng = np.random.default_rng(0)
    pred = gt + rng.normal(0, 0.3, gt.shape).astype(np.float32)
    epes = chip_smoke.pair_epes(pred, gt)
    for i in range(len(ds)):
        (a, b), flow, name = ds[i]
        assert Path(name).name == f"{names[i]}_img1.png"
        np.testing.assert_array_equal(im1[i], a)
        np.testing.assert_array_equal(im2[i], b)
        np.testing.assert_array_equal(gt[i], flow)
        assert epes[i] == pytest.approx(float(np.linalg.norm(pred[i] - flow, axis=-1).mean()), rel=1e-6)


def test_trained_v1_estimate_matches_jax():
    """The port's float32 ``estimate`` with the weights JAX trained, loaded through
    ``run.load_weights`` (``from_jax_params``), on a 128x128 crop of the vortex pair, against JAX's
    ``estimate`` with the same weights: within 1e-3 px."""
    import chip_smoke
    from piv_liteflownet_tpu.inference import estimate as jestimate
    from piv_liteflownet_tpu.models.factory import piv_liteflownet as jpiv
    from piv_liteflownet_tpu.utils.checkpoint import load_params_npz
    from piv_liteflownet_tpu_torch import piv_liteflownet
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.models.factory import config
    from piv_liteflownet_tpu_torch.run import load_weights

    torch.backends.cudnn.allow_tf32 = False
    _, im1, im2, _ = chip_smoke.read_evalset(EVALSET)
    crop = (slice(64, 192), slice(64, 192))
    img1, img2 = np.ascontiguousarray(im1[0][crop]), np.ascontiguousarray(im2[0][crop])
    want = np.asarray(jestimate(jpiv(load_params_npz(str(WEIGHTS_V1)), version=1), img1, img2))
    state, _ = load_weights(SimpleNamespace(params=str(WEIGHTS_V1), model="piv"), config("piv", 1))
    got = estimate(piv_liteflownet(state, version=1, device="cpu"), img1, img2)
    assert got.shape == want.shape == (128, 128, 2)
    assert float(np.abs(want).max()) > 0.5  # a trained flow, not the near-zero flow of random weights
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# -- on the card ---------------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind,b,h,w,off", [
    ("smooth", 1, 256, 512, 0), ("steep", 2, 256, 256, 0), ("shift", 2, 48, 80, 0),
    ("nan", 1, 33, 130, 0), (3.0, 2, 37, 53, 0), (3.0, 2, 40, 64, 1),
])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_kernel_matches_plain_on_card(cuda, kind, b, h, w, off, dtype):
    """The first two cases take two pixels a lane, the others one."""
    rng = np.random.default_rng(h + w)
    img1, img2 = (rng.random((b, h, w, 3), dtype=np.float32) for _ in range(2))

    def place(a):
        t = _nchw(a).to(dtype)
        buf = torch.empty(t.numel() + 16, device=cuda, dtype=dtype)
        return buf[off:off + t.numel()].view(t.shape).copy_(t)

    i1, i2, fl = (place(a) for a in (img1, img2, _flow(kind, b, h, w, seed=w)))
    got = rgb_warp.rgb_warp_norm(i1, i2, fl)
    torch.cuda.synchronize()
    want = rgb_warp.rgb_warp_norm_plain(i1.float(), i2.float(), fl.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    else:
        ref = want.to(BF16).float()
        _, e = torch.frexp(ref.abs())
        assert bool(((got.float() - ref).abs() <= torch.ldexp(torch.ones_like(ref), e - 8) + ATOL).all())
    again = torch.empty_like(got)
    rgb_warp._launch(i1, i2, fl, again)
    torch.cuda.synchronize()
    assert torch.equal(again.view(torch.uint8), got.view(torch.uint8))
