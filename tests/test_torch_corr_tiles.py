"""The cost-volume kernels' tiling, their plain versions at edge shapes, and the kernels on the card.

``csrc/corr49.cu`` and ``csrc/corr49_bwd.cu`` share the tiling of
``csrc/corr_tiles.cuh``; ``ops/correlation.py:tile_plan`` is its host rule.
Here the rule is held to every output pixel and to the shared memory of an
H100; the kernels' index arithmetic (staged rows and columns, the thread
map, the mirrored weights and the backward's shuffle reduction) is replayed
in torch on the CPU thread by thread and held to the plain versions; and the
plain versions, the kernels' oracles, are held to the JAX package at the
shapes where the kernels take their edge cases: maps narrower than the
window, a 1x1 map, one channel, 192 channels at 8x8. The ``gpu`` tests run
the kernels themselves (``--noconftest`` on the card).

Tolerances: atol 1e-5 for the forward against JAX and 1e-5 * max|expected|
for gradients (sums over channels or taps in another order), as in
tests/test_torch_ops.py; on the card 1e-5 * mean|f1*f2| for the forward and
1e-5 * max|plain| for the backward, as chip_smoke.py holds them.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from piv_liteflownet_tpu_torch import kernels
from piv_liteflownet_tpu_torch.ops import correlation as corr

ATOL = 1e-5
CSRC = Path(corr.__file__).resolve().parents[1] / "csrc"

# NHWC shapes where the kernels meet their edge cases
EDGE_SHAPES = [
    (1, 1, 1, 3),     # a 1x1 map
    (2, 2, 3, 5),     # H and W below the window
    (1, 3, 9, 4),     # H = 3
    (1, 6, 2, 2),     # W = 2
    (2, 5, 6, 1),     # one channel
    (1, 8, 8, 192),   # level 6 of a 256^2 input: 8x8, 192 channels
]


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


def _grad_close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    np.testing.assert_allclose(got, want, atol=1e-5 * max(float(np.abs(want).max()), 1.0), err_msg=what)


def _maps(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((*shape[:3], corr.NDISP)).astype(np.float32))


# -- the plain versions against JAX at the edge shapes ---------------------------------

@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_corr49_plain_matches_correlation_xla_at_edge_shapes(shape):
    from piv_liteflownet_tpu.ops.correlation import correlation_xla

    f1, f2, _ = _maps(sum(shape), shape)
    want = np.asarray(correlation_xla(f1, f2, 1))
    np.testing.assert_allclose(_nhwc(corr.corr49_plain(_nchw(f1), _nchw(f2))), want, atol=ATOL)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_corr49_bwd_plain_matches_jax_vjp_at_edge_shapes(shape):
    import jax

    from piv_liteflownet_tpu.ops.correlation import correlation_xla

    f1, f2, g = _maps(sum(shape) + 1, shape)
    _, pull = jax.vjp(lambda a, b: correlation_xla(a, b, 1), f1, f2)
    want1, want2 = (np.asarray(x) for x in pull(g))
    g_f1, g_f2 = corr.corr49_bwd_plain(_nchw(f1), _nchw(f2), _nchw(g))
    _grad_close(_nhwc(g_f1), want1, "g_f1")
    _grad_close(_nhwc(g_f2), want2, "g_f2")


# -- the tile rule ---------------------------------------------------------------------------

def _level_maps(h, w):
    """Cost-volume map sizes of piv v1 on an h x w input: stride 2 (phase-subsampled) below level 4."""
    sizes = []
    for lv in range(1, 7):
        lh, lw = h >> (lv - 1), w >> (lv - 1)
        s = 2 if lv < 4 else 1
        sizes.append((-(-lh // s), -(-lw // s)))
    return sizes


PLAN_SHAPES = sorted({(1, *hw) for hw in _level_maps(1024, 1024)} | {(8, *hw) for hw in _level_maps(256, 256)}
                     | {(2, 37, 53)})


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("b,h,w", PLAN_SHAPES)
def test_tile_plan_covers_every_pixel_once_within_shared_memory(b, h, w, backward):
    plan = corr.tile_plan(b, h, w, backward)
    tw, th = plan.tile
    hits = np.zeros((h, w), np.int64)
    for y0 in plan.y0:
        for x0 in plan.x0:
            hits[y0:y0 + th, x0:x0 + tw] += 1
    assert (hits == 1).all()
    outputs = 2 if backward else 1  # a backward block takes one of the two gradients of its tile
    assert plan.batch == outputs * b and plan.n_tiles == outputs * b * -(-h // th) * -(-w // tw)
    assert plan.smem <= corr.SMEM_LIMIT
    assert plan.edge == (w % 4 != 0)
    assert corr.tile_plan(b, h, w, backward, aligned=False).edge


def _constants(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_tile_rule_mirrors_the_kernel_sources():
    fwd, bwd, common = _constants("corr49.cu"), _constants("corr49_bwd.cu"), _constants("corr_tiles.cuh")
    assert (fwd["TX"], fwd["TY"]) == corr.FWD_TILE and (bwd["TX"], bwd["TY"]) == corr.BWD_TILE
    for src in (fwd, bwd):
        assert (src["CC"], src["NS"]) == (corr.STAGE_CHANNELS, corr.STAGES)
    assert (common["MD"], common["R"]) == (corr.MD, 4)
    # the bytes each source states for SMEM in its comment
    for name, backward in (("corr49.cu", False), ("corr49_bwd.cu", True)):
        stated = re.search(r"constexpr int SMEM = .*// ([\d,]+) bytes", (CSRC / name).read_text())
        assert int(stated.group(1).replace(",", "")) == corr.smem_bytes(backward)


def test_edge_path_rule():
    aligned = torch.zeros(1, 2, 8, 8)
    assert not corr.uses_edge_path(aligned, aligned)
    assert corr.uses_edge_path(torch.zeros(1, 2, 8, 9), torch.zeros(1, 2, 8, 9))
    shifted = torch.zeros(1 + 2 * 64)[1:].view(1, 2, 8, 8)  # contiguous, 4 bytes off
    assert shifted.is_contiguous() and corr.uses_edge_path(shifted, aligned)


# -- the kernels' index arithmetic, replayed thread by thread --------------------------------

def _staged(t: torch.Tensor, plan):
    """Every tile's staged window of ``t [B,C,H,W]``: rows y0-3 .. y0+th+2, columns
    x0-4 .. x0+tw+3, zeros outside -> [B, C, ny, nx, th+6, tw+8]."""
    tw, th = plan.tile
    ny, nx = len(plan.y0), len(plan.x0)
    h, w = t.shape[2:]
    p = F.pad(t, (4, nx * tw - w + 4, 3, ny * th - h + 3))
    win = p.unfold(2, th + 6, th).unfold(3, tw + 8, tw)  # [B,C,ny,nx,th+6,tw+8]
    return win[:, :, :ny, :nx]


def _emulate_forward(f1, f2):
    """``csrc/corr49.cu``: thread (k, ty, dy) of 448 sums pixels x0+4k..x0+4k+3 of row
    y0+ty at displacement row dy from one staged f1 float4 and 12 staged f2 values."""
    b, c, h, w = f1.shape
    plan = corr.tile_plan(b, h, w)
    tw, th = plan.tile
    ny, nx = len(plan.y0), len(plan.x0)
    s2 = _staged(f2, plan)
    s1 = _staged(f1, plan)[..., 3:3 + th, 4:4 + tw]  # the f1 tile itself
    out = torch.zeros(b, corr.NDISP, ny * th, nx * tw)
    writes = torch.zeros(corr.NDISP, ny * th, nx * tw, dtype=torch.int64)
    for tid in range(8 * th * 7):
        k, ty, dy = tid % 8, (tid // 8) % th, tid // (8 * th)
        a = s1[..., ty, 4 * k:4 * k + 4]                 # [B,C,ny,nx,4]
        v = s2[..., ty + dy, 4 * k:4 * k + 12]           # [B,C,ny,nx,12]
        for dx in range(7):
            acc = (a * v[..., dx + 1:dx + 5]).sum(1)     # [B,ny,nx,4]
            d = dy * 7 + dx
            for i in range(4):
                out[:, d, ty::th, 4 * k + i::tw] = acc[..., i] / c
                writes[d, ty::th, 4 * k + i::tw] += 1
    assert (writes == 1).all()
    return out[:, :, :h, :w]


def _reduce_scatter(p: torch.Tensor) -> torch.Tensor:
    """The backward's three shuffle rounds on ``p [32 lanes, 8, ...]``: lane l keeps value l & 7,
    summed over the 8 lanes l ^ 0 .. l ^ 7."""
    lanes = torch.arange(32)

    def pick(bit, a, b):  # per lane: a where the lane's bit is set, else b
        return torch.where((lanes & bit != 0).view(32, *[1] * (a.dim() - 1)), a, b)

    send = pick(4, p[:, 0:4], p[:, 4:8])
    q = pick(4, p[:, 4:8], p[:, 0:4]) + send[lanes ^ 4]
    send = pick(2, q[:, 0:2], q[:, 2:4])
    hh = pick(2, q[:, 2:4], q[:, 0:2]) + send[lanes ^ 2]
    send = pick(1, hh[:, 0], hh[:, 1])
    return pick(1, hh[:, 1], hh[:, 0]) + send[lanes ^ 1]


def _mirror_x(dxi: int) -> int:
    """Column of the mirrored g window of displacement column dxi, from x0 (as ``mirror_x``)."""
    return -4 + 4 * ((dxi + 1) >> 2)


def _emulate_backward(f1, f2, g):
    """``csrc/corr49_bwd.cu``: a block takes one output o of its tile; lane j of a group of 4
    pixels x 2 rows (ty, ty+1) weighs staged row ty+j of f2 (o = 0) or f1 (o = 1), 12 values,
    for output row ty at displacement row j and row ty+1 at j-1, with g at the pixel (o = 0,
    read from g itself) or g from the block's mirrored windows (o = 1); the group's 8 lanes
    reduce, and lane j writes row ty + j//4, pixel x0+4k+j%4."""
    b, c, h, w = f1.shape
    plan = corr.tile_plan(b, h, w, backward=True)
    tw, th = plan.tile
    ny, nx = len(plan.y0), len(plan.x0)
    maps = (_staged(f2, plan), _staged(f1, plan))
    sg = _staged(g, plan) / c                          # [B,49,ny,nx,th+6,tw+8]: rows y0-3.., cols x0-4..
    direct = sg[..., 3:3 + th, 4:4 + tw]               # g at the tile's own pixels
    # the mirrored windows as the kernel stages them: [d][row][36], from plane 48-d
    windows = torch.stack([sg[:, 48 - d, :, :, d // 7:d // 7 + th, _mirror_x(d % 7) + 4:_mirror_x(d % 7) + tw + 8]
                           for d in range(corr.NDISP)], 1)
    outs = torch.zeros(2, b, c, ny * th, nx * tw)
    writes = torch.zeros(2, ny * th, nx * tw, dtype=torch.int64)
    for o in range(2):
        for warp in range(8):
            ty = 2 * (warp >> 1)
            sums = []
            for lane in range(32):
                j, k = lane & 7, 4 * (warp & 1) + (lane >> 3)
                v = maps[o][..., ty + j, 4 * k:4 * k + 12]                # [B,C,ny,nx,12]
                p = torch.zeros(8, b, c, ny, nx)
                for r in range(2):
                    dyi = j - r
                    live, dyc = 0 <= dyi < 7, min(max(dyi, 0), 6)
                    for dx in range(7):
                        d = dyc * 7 + dx
                        if o == 0:
                            wt = direct[:, d, :, :, ty + r, 4 * k:4 * k + 4]
                        else:
                            col = 4 * k + dx - 3 - _mirror_x(dx)
                            wt = windows[:, d, :, :, ty + r, col:col + 4]
                        if not live:
                            wt = torch.zeros_like(wt)
                        for i in range(4):
                            p[4 * r + i] += wt[:, None, ..., i] * v[..., i + dx + 1]
                sums.append(p)
            vals = _reduce_scatter(torch.stack(sums))             # [32, B, C, ny, nx]
            for lane in range(32):
                j, k = lane & 7, 4 * (warp & 1) + (lane >> 3)
                y, x = ty + (j >> 2), 4 * k + (j & 3)
                outs[o, :, :, y::th, x::tw] = vals[lane]
                writes[o, y::th, x::tw] += 1
    assert (writes == 1).all()
    return outs[0, :, :, :h, :w], outs[1, :, :, :h, :w]


EMULATED = [(1, 3, 37, 53), (2, 8, 8, 8), (1, 2, 2, 3), (1, 1, 1, 1)]  # NCHW


@pytest.mark.parametrize("shape", EMULATED)
def test_forward_tiling_replayed_matches_plain(shape):
    rng = np.random.default_rng(shape[2])
    f1, f2 = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    torch.testing.assert_close(_emulate_forward(f1, f2), corr.corr49_plain(f1, f2), rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", EMULATED)
def test_backward_tiling_replayed_matches_plain(shape):
    rng = np.random.default_rng(shape[3])
    f1, f2 = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((shape[0], corr.NDISP, *shape[2:])).astype(np.float32))
    want1, want2 = corr.corr49_bwd_plain(f1, f2, g)
    got1, got2 = _emulate_backward(f1, f2, g)
    for got, want in ((got1, want1), (got2, want2)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(float(want.abs().max()), 1.0))


def test_reduce_scatter_gives_each_lane_one_sum():
    p = torch.arange(32 * 8, dtype=torch.float64).view(32, 8)
    got = _reduce_scatter(p)
    for lane in range(32):
        group = lane & ~7
        assert got[lane] == p[group:group + 8, lane & 7].sum()


# -- the launches' arguments ------------------------------------------------------------------

def test_launches_pass_the_edge_tile_counter(monkeypatch):
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a))
    f1, f2 = torch.zeros(2, 3, 5, 7), torch.zeros(2, 3, 5, 7)
    out, g = torch.zeros(2, 49, 5, 7), torch.zeros(2, 49, 5, 7)
    corr._launch(f1, f2, out)
    corr._launch_bwd(f1, f2, g, torch.zeros_like(f1), torch.zeros_like(f2))
    counter = corr.edge_tile_counter(f1.device)
    assert counter.dtype == torch.int32 and counter.numel() == 1
    (fwd_name, _, _, *fwd), (bwd_name, _, _, *bwd) = calls
    assert fwd_name == "pivk_corr49_f32" and fwd[:4] == [f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
                                                         counter.data_ptr()]
    assert fwd[4:] == [2, 3, 5, 7] and bwd[5] == counter.data_ptr() and bwd[6:] == [2, 3, 5, 7]
    assert bwd_name == "pivk_corr49_bwd_f32"


# -- on the card ---------------------------------------------------------------------------------

CARD_SHAPES = [(1, 64, 512, 512), (8, 64, 128, 128), (1, 192, 8, 8), (2, 3, 37, 53), (2, 5, 2, 3),
               (1, 1, 1, 1), (1, 4, 3, 8)]


def _card_maps(dev, b, c, h, w, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, c, h, w, device=dev, generator=g), torch.randn(b, c, h, w, device=dev, generator=g),
            torch.randn(b, corr.NDISP, h, w, device=dev, generator=g))


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w", CARD_SHAPES)
def test_corr49_kernel_matches_plain_at_level_and_edge_shapes(cuda, b, c, h, w):
    f1, f2, _ = _card_maps(cuda, b, c, h, w, c + h)
    counter = corr.edge_tile_counter(cuda)
    counter.zero_()
    before = corr.launches
    got = corr.corr49(f1, f2)
    torch.cuda.synchronize()
    assert corr.launches == before + 1
    plan = corr.tile_plan(b, h, w)
    assert int(counter.item()) == (plan.n_tiles if plan.edge else 0)
    want = corr.corr49_plain(f1, f2)
    assert float((got - want).abs().max()) <= 1e-5 * float((f1 * f2).abs().mean())


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w", CARD_SHAPES)
def test_corr49_bwd_kernel_matches_plain_at_level_and_edge_shapes(cuda, b, c, h, w):
    f1, f2, gout = _card_maps(cuda, b, c, h, w, c + w)
    g_f1, g_f2 = torch.empty_like(f1), torch.empty_like(f2)
    counter = corr.edge_tile_counter(cuda)
    counter.zero_()
    corr._launch_bwd(f1, f2, gout, g_f1, g_f2)
    torch.cuda.synchronize()
    plan = corr.tile_plan(b, h, w, backward=True)
    assert int(counter.item()) == (plan.n_tiles if plan.edge else 0)
    want1, want2 = corr.corr49_bwd_plain(f1, f2, gout)
    tol = 1e-5 * max(float(want1.abs().max()), float(want2.abs().max()), 1.0)
    assert float((g_f1 - want1).abs().max()) <= tol
    assert float((g_f2 - want2).abs().max()) <= tol


@pytest.mark.gpu
def test_misaligned_maps_take_the_edge_path(cuda):
    b, c, h, w = 1, 8, 16, 32
    base = torch.randn(2 * b * c * h * w + 1, device=cuda)
    f1 = base[1:1 + b * c * h * w].view(b, c, h, w)  # contiguous, 4 bytes off 16
    f2 = base[1 + b * c * h * w:].view(b, c, h, w)
    assert corr.uses_edge_path(f1, f2)
    counter = corr.edge_tile_counter(cuda)
    counter.zero_()
    got = corr.corr49(f1, f2)
    torch.cuda.synchronize()
    assert int(counter.item()) == corr.tile_plan(b, h, w).n_tiles
    assert float((got - corr.corr49_plain(f1, f2)).abs().max()) <= 1e-5 * float((f1 * f2).abs().mean())


@pytest.mark.gpu
def test_corr_kernels_give_the_same_bits_twice(cuda):
    f1, f2, gout = _card_maps(cuda, 8, 64, 128, 128, 11)
    first = corr.corr49(f1, f2)
    second = corr.corr49(f1, f2)
    outs = []
    for _ in range(2):
        g_f1, g_f2 = torch.empty_like(f1), torch.empty_like(f2)
        corr._launch_bwd(f1, f2, gout, g_f1, g_f2)
        outs.append((g_f1, g_f2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def _six_ops(dev):
    """Each of the port's six kernels once on ``dev`` (the two backward ones through autograd)."""
    from piv_liteflownet_tpu_torch.ops import conv_chain, rgb_warp, warp

    g = torch.Generator(device=dev).manual_seed(0)
    f1 = torch.randn(1, 8, 16, 16, device=dev, generator=g).requires_grad_()
    f2 = torch.randn(1, 8, 16, 16, device=dev, generator=g).requires_grad_()
    flow = (torch.rand(1, 2, 16, 16, device=dev, generator=g) * 4 - 2).requires_grad_()
    img = torch.rand(1, 3, 16, 16, device=dev, generator=g)
    wts = [torch.randn(8, 8, 3, 3, device=dev, generator=g) * 0.1, torch.randn(2, 8, 3, 3, device=dev, generator=g)]
    bias = [torch.zeros(8, device=dev), torch.zeros(2, device=dev)]
    yield "corr49", lambda: corr.corr49(f1, f2)
    yield "corr49_bwd", lambda: corr.corr49(f1, f2).sum().backward()
    yield "backwarp", lambda: warp.backwarp(f1.detach(), flow.detach())
    yield "backwarp_bwd", lambda: warp.backwarp(f1, flow).sum().backward()
    yield "rgb_warp_norm", lambda: rgb_warp.rgb_warp_norm(img, img, flow.detach())
    yield "conv_chain", lambda: conv_chain.conv_chain([f1.detach()], wts, bias, True)


@pytest.mark.gpu
def test_ops_on_a_second_card_keep_the_current_device(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    for name, call in _six_ops(torch.device("cuda", 1)):
        call()
        torch.cuda.synchronize(1)
        assert torch.cuda.current_device() == 0, name
