"""The tile rule of the backwarp gradient kernel, and the gradient it computes.

``csrc/backwarp_bwd.cu`` reduces a tile of output pixels in a shared-memory
window when the footprint of its taps fits ``WINDOW_VEC4`` float4, and
scatters every tap of it with global atomics otherwise. ``ops/warp.py:
tile_windows`` is that rule in Python; ``chip_smoke.py`` holds the kernel's
count of out-of-window tiles to it. Here the rule is held to every tap,
computed anew with numpy from seeded flows, and the gradient's plain version
(the oracle of the kernel) to ``jax.vjp`` of the JAX backwarp, with flows
that keep every tile in its window and flows that send tiles out of it.
The ``gpu`` test runs the kernel itself (``--noconftest`` on the card).

Tolerances: the gradients sum over channels and taps in another order than
JAX, so they are held to 1e-5 * max|expected|, as in tests/test_torch_ops.py.
"""

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch.ops import warp


def _smooth_flow(b: int, h: int, w: int) -> np.ndarray:
    """The smooth PIV-like displacement of chip_smoke.py: a shift plus waves of a few pixels."""
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    u = 1.5 + 3.0 * np.sin(2 * np.pi * ys / 256) * np.cos(2 * np.pi * xs / 384)
    v = -0.5 + 2.0 * np.cos(2 * np.pi * xs / 300)
    flow = np.stack(np.broadcast_arrays(u, v)).astype(np.float32)
    return np.repeat(flow[None], b, axis=0)


def _random_flow(seed: int, b: int, ho: int, wo: int, mag: float) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-mag, mag, (b, 2, ho, wo)).astype(np.float32)


def _taps(flow: np.ndarray, h: int, w: int, stride: int):
    """Every tap of every output pixel, in float32 as the kernel computes them:
    (cx, cy, inside) of shape [4, B, ho, wo]."""
    ho, wo = flow.shape[2:]
    x = (np.arange(wo, dtype=np.float32) * np.float32(stride))[None, None, :] + flow[:, 0]
    y = (np.arange(ho, dtype=np.float32) * np.float32(stride))[None, :, None] + flow[:, 1]
    x0, y0 = np.floor(x), np.floor(y)
    cx = np.stack([x0, x0 + 1, x0, x0 + 1])
    cy = np.stack([y0, y0, y0 + 1, y0 + 1])
    inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
    return cx, cy, inside


def _rule(flow: np.ndarray, h: int, w: int, stride: int):
    return warp.tile_windows(torch.from_numpy(flow), h, w, stride)


def _check_tiles(flow: np.ndarray, h: int, w: int, stride: int):
    """Hold every tile of ``tile_windows`` to its taps; returns (tiles that fit, tiles that do not)."""
    rule = _rule(flow, h, w, stride)
    cx, cy, inside = _taps(flow, h, w, stride)
    b, _, ho, wo = flow.shape
    tw, th = warp.TILE_W, warp.TILE_H
    assert tuple(rule.fits.shape) == (b, -(-ho // th), -(-wo // tw))
    n_fit = n_out = 0
    for bi, ty, tx in np.ndindex(*rule.fits.shape):
        sl = (slice(None), bi, slice(ty * th, (ty + 1) * th), slice(tx * tw, (tx + 1) * tw))
        ok = inside[sl]
        x0, y0 = int(rule.x0[bi, ty, tx]), int(rule.y0[bi, ty, tx])
        width, height = int(rule.width[bi, ty, tx]), int(rule.height[bi, ty, tx])
        fits = bool(rule.fits[bi, ty, tx])
        if not ok.any():  # no tap inside the map: nothing to scatter, and the tile fits
            assert (width, height) == (0, 0) and fits
            n_fit += 1
            continue
        xs, ys = cx[sl][ok], cy[sl][ok]
        # the footprint is the taps' bounding box, its x origin a multiple of 4 at or below
        assert x0 % 4 == 0 and x0 <= xs.min() < x0 + 4
        assert (x0 + width - 1, y0, y0 + height - 1) == (xs.max(), ys.min(), ys.max())
        nvx = -(-width // 4)
        assert fits == (nvx * height <= warp.WINDOW_VEC4)
        if fits:
            # every tap inside the map lands in the window, whose rows hold nvx float4
            cell = (ys - y0) * 4 * nvx + (xs - x0)
            assert (xs - x0 < 4 * nvx).all() and (cell >= 0).all() and (cell < 4 * warp.WINDOW_VEC4).all()
            n_fit += 1
        else:
            n_out += 1
    assert warp.out_of_window_tiles(torch.from_numpy(flow), h, w, stride) == n_out
    return n_fit, n_out


@pytest.mark.parametrize("b,h,w,stride,mag,seed", [
    (2, 37, 53, 1, 3.0, 0),     # odd size, a few taps past the border
    (1, 37, 53, 1, 12.0, 1),
    (2, 40, 72, 2, 4.0, 2),
    (1, 37, 53, 2, 25.0, 3),    # odd size at stride 2, flows far outside
    (1, 9, 130, 1, 40.0, 4),    # wider than a tile: tiles out of the window
    (2, 33, 65, 2, 9.0, 5),
])
def test_every_tap_of_a_fitting_tile_lies_in_its_window(b, h, w, stride, mag, seed):
    ho, wo = warp.out_hw(h, w, stride)
    flow = _random_flow(seed, b, ho, wo, mag)
    assert not _taps(flow, h, w, stride)[2].all()  # some taps lie outside the map
    n_fit, n_out = _check_tiles(flow, h, w, stride)
    assert n_fit + n_out == b * -(-ho // warp.TILE_H) * -(-wo // warp.TILE_W)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["zero", "smooth"])
def test_zero_and_smooth_flows_fit_every_tile(stride, kind):
    b, h, w = 1, 256, 256
    ho, wo = warp.out_hw(h, w, stride)
    flow = np.zeros((b, 2, ho, wo), np.float32) if kind == "zero" else _smooth_flow(b, ho, wo)
    n_fit, n_out = _check_tiles(flow, h, w, stride)
    assert n_out == 0 and n_fit == ho * -(-wo // warp.TILE_W)


@pytest.mark.parametrize("stride", [1, 2])
def test_30px_flow_sends_tiles_out_of_the_window(stride):
    b, h, w = 2, 64, 96
    ho, wo = warp.out_hw(h, w, stride)
    n_fit, n_out = _check_tiles(_random_flow(30 + stride, b, ho, wo, 30.0), h, w, stride)
    assert n_out > 0


@pytest.mark.parametrize("stride", [1, 2])
def test_footprint_size_at_zero_flow(stride):
    """A tile of TILE_W x TILE_H pixels reads s*(TILE_W-1)+2 columns and s*(TILE_H-1)+2 rows
    (a tap past the last pixel only where that lies inside the map); at stride 2 that is
    64 columns for a tile of 32."""
    h, w = 40, 70
    ho, wo = warp.out_hw(h, w, stride)
    rule = _rule(np.zeros((1, 2, ho, wo), np.float32), h, w, stride)
    full_w = stride * (warp.TILE_W - 1) + 2
    full_h = stride * (warp.TILE_H - 1) + 2
    assert int(rule.width[0, 0, 0]) == full_w and int(rule.height[0, 0, 0]) == full_h
    if stride == 2:
        assert full_w == 64
    # the last column of tiles starts at its first pixel and ends at the map's last column
    assert int(rule.x0[0, 0, -1]) == stride * warp.TILE_W * (rule.x0.shape[2] - 1)
    assert int(rule.x0[0, 0, -1] + rule.width[0, 0, -1]) == w
    # the last row of tiles: its lower taps fall off the map at stride 1 only
    assert int(rule.y0[0, -1, 0] + rule.height[0, -1, 0]) == min(stride * (ho - 1) + 2, h)
    assert bool(rule.fits.all())


def test_out_of_window_counter_is_one_int32_per_device():
    cpu = torch.device("cpu")
    counter = warp.out_of_window_counter(cpu)
    assert counter.dtype == torch.int32 and tuple(counter.shape) == (1,) and counter.device == cpu
    assert warp.out_of_window_counter(cpu) is counter


def _grad_close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    tol = 1e-5 * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("b,c,h,w,stride,kind", [
    (2, 3, 40, 72, 1, "smooth"),   # every tile in its window
    (1, 4, 37, 53, 1, 30.0),       # odd size, tiles out of the window
    (2, 3, 40, 72, 2, "smooth"),
    (1, 4, 37, 53, 2, 30.0),
])
def test_gradient_matches_jax_vjp(b, c, h, w, stride, kind):
    """backwarp_bwd_plain, the oracle of the kernel on both of its paths, against jax.vjp
    of piv_liteflownet_tpu/ops/warp.py:backwarp."""
    import jax

    from piv_liteflownet_tpu.ops.warp import backwarp as jbackwarp

    ho, wo = warp.out_hw(h, w, stride)
    flow = _smooth_flow(b, ho, wo) if kind == "smooth" else _random_flow(h + stride, b, ho, wo, kind)
    n_out = warp.out_of_window_tiles(torch.from_numpy(flow), h, w, stride)
    assert (n_out == 0) == (kind == "smooth")
    rng = np.random.default_rng(c * stride)
    img = rng.standard_normal((b, h, w, c)).astype(np.float32)
    gout = rng.standard_normal((b, ho, wo, c)).astype(np.float32)
    flow_nhwc = np.ascontiguousarray(flow.transpose(0, 2, 3, 1))
    _, pull = jax.vjp(lambda a, f: jbackwarp(a, f, stride), img, flow_nhwc)
    want_img, want_flow = (np.asarray(g) for g in pull(gout))

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    g_img, g_flow = warp.backwarp_bwd_plain(nchw(img), torch.from_numpy(flow), nchw(gout), stride)
    _grad_close(g_img.permute(0, 2, 3, 1), want_img, "g_img")
    _grad_close(g_flow.permute(0, 2, 3, 1), want_flow, "g_flow")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w,stride,kind", [
    (2, 5, 37, 53, 1, "smooth"), (2, 5, 37, 53, 1, 30.0), (2, 7, 64, 96, 2, "smooth"),
    (2, 7, 64, 96, 2, 30.0), (1, 3, 9, 130, 1, 40.0),
])
def test_kernel_counts_out_of_window_tiles_as_the_rule(cuda, b, c, h, w, stride, kind):
    ho, wo = warp.out_hw(h, w, stride)
    flow_np = _smooth_flow(b, ho, wo) if kind == "smooth" else _random_flow(w + stride, b, ho, wo, kind)
    g = torch.Generator(device=cuda).manual_seed(c)
    img = torch.randn(b, c, h, w, device=cuda, generator=g)
    gout = torch.randn(b, c, ho, wo, device=cuda, generator=g)
    flow = torch.from_numpy(flow_np).to(cuda)
    g_img, g_flow = torch.empty_like(img), torch.empty_like(flow)
    counter = warp.out_of_window_counter(torch.device("cuda"))  # the current card's
    assert counter is warp.out_of_window_counter(flow.device)
    counter.zero_()
    warp._launch_bwd(img, flow, gout, stride, g_img, g_flow)
    torch.cuda.synchronize()
    assert int(counter.item()) == warp.out_of_window_tiles(flow, h, w, stride)
    want_img, want_flow = warp.backwarp_bwd_plain(img, flow, gout, stride)
    tol = 1e-5 * max(float(want_img.abs().max()), float(want_flow.abs().max()), 1.0)
    assert float((g_img - want_img).abs().max()) <= tol
    assert float((g_flow - want_flow).abs().max()) <= tol
