"""Ops of the PyTorch port against the JAX package, and the kernel wrappers.

Inputs are made with numpy from a seed and handed to both packages; the JAX
functions run on the CPU (Pallas kernels in interpret mode). The JAX package
is imported inside the tests, so the ``gpu``-marked tests also collect on a
machine without JAX (run there with ``--noconftest``).

Tolerances: atol 1e-5 in float32, where the two sides sum in another order;
gradients that sum over channels or taps are held to 1e-5 * max|expected|.
The card tests hold each CUDA kernel to its plain version on the same inputs:
atol 1e-5 for the warps, 1e-5 * mean|f1*f2| for the cost volume, whose
channel sum runs in another order, and 1e-5 * max|plain| for the backward
kernels (atomics in another, varying order; sums over 49 taps or C channels).
"""

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch.kernels import build
from piv_liteflownet_tpu_torch.ops import correlation, rgb_warp, warp
from piv_liteflownet_tpu_torch.ops.nn import depthwise_deconv4x2, leaky_relu, unfold
from piv_liteflownet_tpu_torch.ops.resize import avg_pool, resize_bilinear

ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _flow(rng, b, h, w, mag):
    return (rng.uniform(-mag, mag, (b, h, w, 2))).astype(np.float32)


# -- resize, deconv, unfold, leaky_relu -------------------------------------

@pytest.mark.parametrize("src,dst", [((64, 96), (32, 48)), ((70, 100), (96, 128)),
                                     ((96, 128), (70, 100)), ((37, 53), (37, 53))])
def test_resize_matches_jax(src, dst):
    from piv_liteflownet_tpu.ops.resize import resize_bilinear as jresize

    x = np.random.default_rng(0).random((2, *src, 3), dtype=np.float32)
    want = np.asarray(jresize(x, *dst))
    got = _nhwc(resize_bilinear(_nchw(x), *dst))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("c", [2, 49])
def test_depthwise_deconv_matches_jax(c):
    from piv_liteflownet_tpu.ops.nn import depthwise_deconv4x2 as jdeconv

    rng = np.random.default_rng(c)
    x = rng.standard_normal((2, 9, 13, c)).astype(np.float32)
    w_jax = rng.standard_normal((4, 4, 1, c)).astype(np.float32)  # flipped HWIO
    w_torch = np.ascontiguousarray(np.transpose(w_jax, (3, 2, 0, 1))[:, :, ::-1, ::-1])
    want = np.asarray(jdeconv(x, w_jax))
    got = _nhwc(depthwise_deconv4x2(_nchw(x), torch.from_numpy(w_torch)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_unfold_and_leaky_relu_match_jax(k):
    from piv_liteflownet_tpu.ops.nn import leaky_relu as jlrelu
    from piv_liteflownet_tpu.ops.nn import unfold_nhwc

    x = np.random.default_rng(k).standard_normal((2, 11, 17, 1)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(unfold(_nchw(x), k)), np.asarray(unfold_nhwc(x, k)))
    np.testing.assert_array_equal(_nhwc(leaky_relu(_nchw(x))), np.asarray(jlrelu(x)))


def test_unfold_rejects_many_channels():
    with pytest.raises(ValueError):
        unfold(torch.zeros(1, 2, 5, 5), 3)


# -- backwarp ----------------------------------------------------------------

@pytest.mark.parametrize("shape,stride,mag", [
    ((2, 16, 24, 5), 1, 3.0),
    ((1, 37, 53, 3), 1, 12.0),   # odd size, many taps outside the frame
    ((2, 32, 48, 8), 2, 4.0),
    ((1, 37, 53, 4), 2, 25.0),   # odd size at stride 2, flows far outside
])
def test_backwarp_matches_jax(shape, stride, mag):
    from piv_liteflownet_tpu.ops.warp import backwarp as jbackwarp

    rng = np.random.default_rng(sum(shape) + stride)
    b, h, w, c = shape
    img = rng.standard_normal(shape).astype(np.float32)
    flow = _flow(rng, b, -(-h // stride), -(-w // stride), mag)
    want = np.asarray(jbackwarp(img, flow, stride))
    before = warp.launches
    got = _nhwc(warp.backwarp(_nchw(img), _nchw(flow), stride))
    assert warp.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_backwarp_zero_flow_is_identity_and_subsample():
    img = torch.randn(1, 3, 10, 13, generator=torch.Generator().manual_seed(0))
    zero1 = torch.zeros(1, 2, 10, 13)
    zero2 = torch.zeros(1, 2, 5, 7)
    torch.testing.assert_close(warp.backwarp(img, zero1), img, rtol=0, atol=0)
    torch.testing.assert_close(warp.backwarp(img, zero2, 2), img[:, :, ::2, ::2], rtol=0, atol=0)


def test_backwarp_huge_flow_reads_zeros():
    img = torch.ones(1, 2, 6, 7)
    flow = torch.full((1, 2, 6, 7), 1e30)
    assert torch.count_nonzero(warp.backwarp(img, flow)) == 0


def _grad_close(got: torch.Tensor, want, what: str, rel: float = 1e-5) -> None:
    want = np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got, want,
                               rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("shape,stride,mag", [
    ((2, 16, 24, 5), 1, 3.0),
    ((1, 37, 53, 3), 1, 30.0),   # odd size, flows up to 30 px past the border
    ((2, 32, 48, 4), 2, 4.0),
    ((1, 37, 53, 4), 2, 30.0),
])
def test_backwarp_bwd_plain_matches_jax_vjp(shape, stride, mag):
    """The explicit gradient formula against jax.vjp of the JAX backwarp, and against autograd."""
    import jax

    from piv_liteflownet_tpu.ops.warp import backwarp as jbackwarp

    rng = np.random.default_rng(sum(shape) * stride)
    b, h, w, c = shape
    ho, wo = warp.out_hw(h, w, stride)
    img = rng.standard_normal(shape).astype(np.float32)
    flow = _flow(rng, b, ho, wo, mag)
    gout = rng.standard_normal((b, ho, wo, c)).astype(np.float32)
    _, pull = jax.vjp(lambda a, f: jbackwarp(a, f, stride), img, flow)
    want_img, want_flow = (np.asarray(g) for g in pull(gout))

    g_img, g_flow = warp.backwarp_bwd_plain(_nchw(img), _nchw(flow), _nchw(gout), stride)
    _grad_close(_nhwc(g_img), want_img, "g_img")
    _grad_close(_nhwc(g_flow), want_flow, "g_flow")

    timg, tflow = _nchw(img).requires_grad_(), _nchw(flow).requires_grad_()
    warp.backwarp(timg, tflow, stride).backward(_nchw(gout))
    _grad_close(_nhwc(timg.grad), want_img, "autograd g_img")
    _grad_close(_nhwc(tflow.grad), want_flow, "autograd g_flow")


def test_backwarp_image_grad_matches_tpu_kernel_interpret():
    """The image gradient against the TPU warp-VJP kernel itself (interpret mode), within
    its bounds (w >= 128, h >= 16, a smooth flow), as tests/test_warp_vjp.py runs it."""
    from piv_liteflownet_tpu.ops.pallas_warp_vjp import warp_img_grad_bounds_ok, warp_img_grad_pallas

    b, h, w, c = 1, 32, 128, 4
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:h, 0:w]
    u = 1.3 + np.sin(xx / 60.0) + 0.4 * np.cos(yy / 35.0)
    v = -0.7 + np.cos(xx / 50.0) + 0.5 * np.sin(yy / 25.0)
    flow = np.stack([u, v], -1).astype(np.float32)[None]
    img = rng.random((b, h, w, c), dtype=np.float32)
    gout = rng.random((b, h, w, c), dtype=np.float32)
    assert bool(warp_img_grad_bounds_ok(flow, ry=2))
    want = np.asarray(warp_img_grad_pallas(gout, flow, ry=2, interpret=True))
    got, _ = warp.backwarp_bwd_plain(_nchw(img), _nchw(flow), _nchw(gout))
    np.testing.assert_allclose(_nhwc(got), want, atol=3e-5, rtol=1e-4)  # tests/test_warp_vjp.py's


# -- cost volume --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 24, 8), (1, 13, 19, 3), (1, 8, 8, 64)])
def test_corr49_matches_correlation_xla(shape):
    from piv_liteflownet_tpu.ops.correlation import correlation_xla

    rng = np.random.default_rng(len(shape) + shape[-1])
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(correlation_xla(f1, f2, 1))
    got = _nhwc(correlation.corr49(_nchw(f1), _nchw(f2)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_corr49_on_phase_subsampled_maps_is_stride2_correlation():
    from piv_liteflownet_tpu.ops.correlation import correlation_xla

    rng = np.random.default_rng(7)
    f1 = rng.standard_normal((1, 18, 27, 6)).astype(np.float32)
    f2 = rng.standard_normal((1, 18, 27, 6)).astype(np.float32)
    want = np.asarray(correlation_xla(f1, f2, 2))
    got = correlation.corr49(_nchw(f1)[:, :, ::2, ::2].contiguous(),
                             _nchw(f2)[:, :, ::2, ::2].contiguous())
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 32, 48, 8), (2, 24, 40, 3)])
def test_corr49_matches_tpu_kernel_interpret(shape):
    """The plain version against the TPU kernel itself, as tests/test_pallas_corr.py runs it."""
    from piv_liteflownet_tpu.ops.pallas_corr import correlation_pallas

    rng = np.random.default_rng(0)
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(correlation_pallas(f1, f2, tile_h=8, interpret=True))
    got = _nhwc(correlation.corr49_plain(_nchw(f1), _nchw(f2)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 16, 24, 8), (1, 13, 19, 3)])
def test_corr49_bwd_plain_matches_jax_vjp(shape):
    """The explicit gradient formula against jax.vjp of correlation_xla, and against autograd."""
    import jax

    from piv_liteflownet_tpu.ops.correlation import correlation_xla

    rng = np.random.default_rng(shape[-1])
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((*shape[:3], 49)).astype(np.float32)
    _, pull = jax.vjp(lambda a, b: correlation_xla(a, b, 1), f1, f2)
    want1, want2 = (np.asarray(x) for x in pull(g))
    g_f1, g_f2 = correlation.corr49_bwd_plain(_nchw(f1), _nchw(f2), _nchw(g))
    _grad_close(_nhwc(g_f1), want1, "g_f1")
    _grad_close(_nhwc(g_f2), want2, "g_f2")
    t1, t2 = _nchw(f1).requires_grad_(), _nchw(f2).requires_grad_()
    correlation.corr49(t1, t2).backward(_nchw(g))
    _grad_close(_nhwc(t1.grad), want1, "autograd g_f1")
    _grad_close(_nhwc(t2.grad), want2, "autograd g_f2")


def test_corr49_bwd_on_phase_subsampled_maps_is_stride2_vjp():
    """On the even phase, as the stride-2 NetE-M path runs it: the JAX stride-2 VJP puts the
    same gradient on the even pixels and zero on the others."""
    import jax

    from piv_liteflownet_tpu.ops.correlation import correlation_xla

    rng = np.random.default_rng(5)
    f1 = rng.standard_normal((1, 18, 27, 6)).astype(np.float32)
    f2 = rng.standard_normal((1, 18, 27, 6)).astype(np.float32)
    g = rng.standard_normal((1, 9, 14, 49)).astype(np.float32)
    _, pull = jax.vjp(lambda a, b: correlation_xla(a, b, 2), f1, f2)
    want1, want2 = (np.asarray(x) for x in pull(g))
    g_f1, g_f2 = correlation.corr49_bwd_plain(_nchw(f1)[:, :, ::2, ::2].contiguous(),
                                              _nchw(f2)[:, :, ::2, ::2].contiguous(), _nchw(g))
    for got, want, what in ((g_f1, want1, "g_f1"), (g_f2, want2, "g_f2")):
        _grad_close(_nhwc(got), want[:, ::2, ::2], what)
        odd = want.copy()
        odd[:, ::2, ::2] = 0
        assert not odd.any()


# -- rgb warp + occlusion norm -------------------------------------------------

def _rgb_case(seed, shape, base_mag, var_mag):
    rng = np.random.default_rng(seed)
    b, h, w = shape
    img1 = rng.random((b, h, w, 3), dtype=np.float32)
    img2 = rng.random((b, h, w, 3), dtype=np.float32)
    base = rng.uniform(-base_mag, base_mag, (b, 1, 1, 2)).astype(np.float32)
    var = rng.standard_normal((b, h, w, 2)).astype(np.float32) * var_mag
    return img1, img2, base + var


@pytest.mark.parametrize("shape,base_mag,var_mag", [
    ((2, 16, 24), 2.0, 0.5),
    ((1, 37, 53), 10.0, 4.0),   # odd size, taps outside the frame
    ((1, 20, 30), 40.0, 1.0),   # mostly outside: the norm tends to |img1|
])
def test_rgb_warp_norm_matches_gather(shape, base_mag, var_mag):
    from piv_liteflownet_tpu.ops.pallas_rgb_warp import rgb_warp_norm_gather

    img1, img2, flow = _rgb_case(sum(shape), shape, base_mag, var_mag)
    want = np.asarray(rgb_warp_norm_gather(img1, img2, flow))
    before = rgb_warp.launches
    got = _nhwc(rgb_warp.rgb_warp_norm(_nchw(img1), _nchw(img2), _nchw(flow)))
    assert rgb_warp.launches == before
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 64, 128), (1, 50, 96)])
def test_rgb_warp_norm_matches_tpu_kernel_interpret(shape):
    """Against the unguarded TPU kernel, as tests/test_rgb_norm.py runs it.

    The flows stay inside the tent's bounds (|u| <= lim, tile residual <= r),
    where that kernel is exact; beyond them it clamps by design, and there
    the port is held to rgb_warp_norm_gather (the test above).
    """
    from piv_liteflownet_tpu.ops.pallas_rgb_warp import rgb_norm_bounds_ok, rgb_warp_norm_pallas

    img1, img2, flow = _rgb_case(5, shape, 4.0, 0.3)
    assert bool(rgb_norm_bounds_ok(flow, r=3, lim=8))
    want = np.asarray(rgb_warp_norm_pallas(img1, img2, flow, r=3, lim=8, interpret=True))
    got = _nhwc(rgb_warp.rgb_warp_norm_plain(_nchw(img1), _nchw(img2), _nchw(flow)))
    np.testing.assert_allclose(got, want, atol=2e-5)  # the tolerance of tests/test_rgb_norm.py


def test_rgb_warp_norm_has_no_gradient():
    """No gradient reaches the flow or the images through the norm, on the plain path and
    through the kernel path (its launch faked with the plain version)."""
    from piv_liteflownet_tpu_torch import kernels

    img1, img2, flow = (_nchw(a).requires_grad_() for a in _rgb_case(3, (1, 16, 24), 2.0, 0.5))
    out = rgb_warp.rgb_warp_norm(img1, img2, flow)
    assert not out.requires_grad and out.grad_fn is None
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(kernels, "on_cuda", lambda op, *tensors: True)
        m.setattr(rgb_warp, "_launch",
                  lambda a, b, f, o: o.copy_(rgb_warp.rgb_warp_norm_plain(a, b, f)))
        faked = rgb_warp.rgb_warp_norm(img1, img2, flow)
    assert not faked.requires_grad and faked.grad_fn is None
    torch.testing.assert_close(faked, out, rtol=0, atol=0)
    # the plain version itself is differentiable: the wrapper is what cuts the graph
    assert rgb_warp.rgb_warp_norm_plain(img1, img2, flow).requires_grad


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_avg_pool_matches_jax(k):
    from piv_liteflownet_tpu.ops.resize import avg_pool as javg_pool

    x = np.random.default_rng(k).standard_normal((2, 37, 50, 2)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(avg_pool(_nchw(x), k)), np.asarray(javg_pool(x, k)), atol=ATOL)


# -- wrapper checks: no fallback off the CPU --------------------------------------

def _meta(*shape):
    return torch.empty(*shape, device="meta")


@pytest.mark.parametrize("call", [
    lambda: correlation.corr49(_meta(1, 4, 8, 8), _meta(1, 4, 8, 8)),
    lambda: warp.backwarp(_meta(1, 4, 8, 8), _meta(1, 2, 8, 8)),
    lambda: rgb_warp.rgb_warp_norm(_meta(1, 3, 8, 8), _meta(1, 3, 8, 8), _meta(1, 2, 8, 8)),
])
def test_wrappers_raise_on_devices_without_a_kernel(call):
    with pytest.raises(ValueError, match="no kernel or plain path"):
        call()


@pytest.mark.parametrize("call,err", [
    (lambda: correlation.corr49(torch.zeros(1, 4, 8, 8), torch.zeros(1, 4, 8, 9)), ValueError),
    (lambda: correlation.corr49(torch.zeros(1, 4, 8, 8).double(), torch.zeros(1, 4, 8, 8).double()),
     TypeError),
    (lambda: warp.backwarp(torch.zeros(1, 4, 8, 8), torch.zeros(1, 2, 8, 8), 2), ValueError),
    (lambda: warp.backwarp(torch.zeros(1, 4, 8, 8), torch.zeros(1, 2, 4, 4), 3), ValueError),
    (lambda: warp.backwarp(torch.zeros(1, 8, 8, 4).permute(0, 3, 1, 2), torch.zeros(1, 2, 8, 8)),
     ValueError),
    (lambda: rgb_warp.rgb_warp_norm(torch.zeros(1, 4, 8, 8), torch.zeros(1, 4, 8, 8),
                                    torch.zeros(1, 2, 8, 8)), ValueError),
])
def test_wrappers_check_shape_dtype_and_layout(call, err):
    with pytest.raises(err):
        call()


def test_build_without_nvcc_raises_and_digest_covers_sources():
    names = [p.name for p in build.sources()]
    assert {"corr49.cu", "corr49_bwd.cu", "backwarp.cu", "backwarp_bwd.cu", "rgb_warp_norm.cu",
            "bilinear.cuh"} <= set(names)
    assert len(build.source_digest()) == 64
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(nvcc="/nonexistent/nvcc", force=True)


# -- on the card: each kernel against its plain version --------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w", [(1, 64, 64, 96), (2, 3, 37, 53), (1, 192, 8, 8)])
def test_corr49_kernel_matches_plain(cuda, b, c, h, w):
    g = torch.Generator(device=cuda).manual_seed(c)
    f1 = torch.randn(b, c, h, w, device=cuda, generator=g)
    f2 = torch.randn(b, c, h, w, device=cuda, generator=g)
    before = correlation.launches
    got = correlation.corr49(f1, f2)
    torch.cuda.synchronize()
    assert correlation.launches == before + 1
    want = correlation.corr49_plain(f1, f2)
    tol = 1e-5 * float((f1 * f2).abs().mean())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w,stride,mag", [
    (1, 64, 64, 96, 1, 4.0), (2, 5, 37, 53, 1, 30.0), (1, 64, 64, 96, 2, 4.0), (2, 7, 37, 53, 2, 30.0),
])
def test_backwarp_kernel_matches_plain(cuda, b, c, h, w, stride, mag):
    g = torch.Generator(device=cuda).manual_seed(h + stride)
    img = torch.randn(b, c, h, w, device=cuda, generator=g)
    ho, wo = warp.out_hw(h, w, stride)
    flow = (torch.rand(b, 2, ho, wo, device=cuda, generator=g) * 2 - 1) * mag
    before = warp.launches
    got = warp.backwarp(img, flow, stride)
    torch.cuda.synchronize()
    assert warp.launches == before + 1
    torch.testing.assert_close(got, warp.backwarp_plain(img, flow, stride), rtol=0, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,mag", [(1, 64, 96, 4.0), (2, 37, 53, 30.0)])
def test_rgb_warp_norm_kernel_matches_plain(cuda, b, h, w, mag):
    g = torch.Generator(device=cuda).manual_seed(w)
    img1 = torch.rand(b, 3, h, w, device=cuda, generator=g)
    img2 = torch.rand(b, 3, h, w, device=cuda, generator=g)
    flow = (torch.rand(b, 2, h, w, device=cuda, generator=g) * 2 - 1) * mag
    before = rgb_warp.launches
    got = rgb_warp.rgb_warp_norm(img1, img2, flow)
    torch.cuda.synchronize()
    assert rgb_warp.launches == before + 1
    torch.testing.assert_close(got, rgb_warp.rgb_warp_norm_plain(img1, img2, flow), rtol=0, atol=ATOL)


def _card_grad_close(got: torch.Tensor, want: torch.Tensor) -> None:
    tol = 1e-5 * max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w,stride,mag", [
    (1, 64, 64, 96, 1, 4.0), (2, 5, 37, 53, 1, 30.0), (1, 64, 64, 96, 2, 4.0), (2, 7, 37, 53, 2, 30.0),
])
def test_backwarp_bwd_kernel_matches_plain(cuda, b, c, h, w, stride, mag):
    g = torch.Generator(device=cuda).manual_seed(c + stride)
    img = torch.randn(b, c, h, w, device=cuda, generator=g).requires_grad_()
    ho, wo = warp.out_hw(h, w, stride)
    flow = ((torch.rand(b, 2, ho, wo, device=cuda, generator=g) * 2 - 1) * mag).requires_grad_()
    gout = torch.randn(b, c, ho, wo, device=cuda, generator=g)
    before = warp.bwd_launches
    warp.backwarp(img, flow, stride).backward(gout)
    torch.cuda.synchronize()
    assert warp.bwd_launches == before + 1
    want_img, want_flow = warp.backwarp_bwd_plain(img.detach(), flow.detach(), gout, stride)
    _card_grad_close(img.grad, want_img)
    _card_grad_close(flow.grad, want_flow)


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w", [(1, 64, 64, 96), (2, 3, 37, 53), (1, 192, 8, 8)])
def test_corr49_bwd_kernel_matches_plain(cuda, b, c, h, w):
    g = torch.Generator(device=cuda).manual_seed(c + 1)
    f1 = torch.randn(b, c, h, w, device=cuda, generator=g).requires_grad_()
    f2 = torch.randn(b, c, h, w, device=cuda, generator=g).requires_grad_()
    gout = torch.randn(b, 49, h, w, device=cuda, generator=g)
    before = correlation.bwd_launches
    correlation.corr49(f1, f2).backward(gout)
    torch.cuda.synchronize()
    assert correlation.bwd_launches == before + 1
    want1, want2 = correlation.corr49_bwd_plain(f1.detach(), f2.detach(), gout)
    _card_grad_close(f1.grad, want1)
    _card_grad_close(f2.grad, want2)


@pytest.mark.gpu
def test_rgb_warp_norm_kernel_has_no_gradient(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    img1, img2 = (torch.rand(1, 3, 32, 48, device=cuda, generator=g) for _ in range(2))
    flow = (torch.rand(1, 2, 32, 48, device=cuda, generator=g) * 4 - 2).requires_grad_()
    out = rgb_warp.rgb_warp_norm(img1, img2, flow)
    assert not out.requires_grad and out.grad_fn is None
