"""The owner rule of the backwarp gradient kernel's bf16 form, and the partition it makes.

``csrc/backwarp_bwd.cu``'s bf16 form cuts the image gradient into owner
rectangles of ``OWNER_W x OWNER_H`` pixels. A pre-pass over the flow gives each
rectangle a candidate box of output pixels; one block sums, for each element of
its rectangle, the taps of the box's pixels that land there, and a rectangle
with more than ``OWNER_CAP`` candidates takes a slower path.
``ops/warp.py:owner_rects`` is that rule in Python; ``chip_smoke.py`` and the
``gpu`` tests here hold the kernel's count of slow rectangles and its boxes to
it. Here the rule is held to every tap, computed anew with numpy from seeded
flows (zero, smooth, random up to 8 and 30 px, out of the frame, a zoom that
converges), at both strides and odd sizes: every output pixel with a tap in a
rectangle lies in that rectangle's box, the candidate count is the number of
such pixels, and summing each rectangle over its box in float64 reproduces the
plain gradient (``backwarp_bwd_plain``) to 1e-12, every pixel's flow gradient
belonging to the one rectangle that holds its anchor. The rule's constants are
read from the source.

The ``gpu`` tests (``--noconftest`` on the card) run the kernel: its boxes
and slow-path count against the rule, its gradients against the float32 plain
version rounded to bf16 (within one bf16 ulp plus 1e-5 * max|plain|), and two
launches bit-equal.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch.ops import warp

SRC = Path(__file__).resolve().parents[1] / "piv_liteflownet_tpu_torch" / "csrc" / "backwarp_bwd.cu"
BF16 = torch.bfloat16


def _flow(kind, b: int, ho: int, wo: int, h: int, w: int, stride: int, seed: int) -> np.ndarray:
    """A seeded flow ``[b,2,ho,wo]`` (float32) of the given kind."""
    ys = np.arange(ho, dtype=np.float32)[:, None] * stride
    xs = np.arange(wo, dtype=np.float32)[None, :] * stride
    if kind == "zero":
        u, v = np.zeros_like(xs + ys), np.zeros_like(xs + ys)
    elif kind == "smooth":  # chip_smoke.py's PIV-like field
        u = 1.5 + 3.0 * np.sin(2 * np.pi * ys / 256) * np.cos(2 * np.pi * xs / 384)
        v = -0.5 + 2.0 * np.cos(2 * np.pi * xs / 300) + 0 * ys
    elif kind == "out":  # most samples beyond the right and bottom edges
        u, v = np.full_like(xs + ys, 0.8 * w), np.full_like(xs + ys, 0.6 * h)
    elif kind == "zoom":  # converges: 0.3 of the frame sampled by all of it
        u, v = -0.7 * (xs - w / 2) + 0 * ys, -0.7 * (ys - h / 2) + 0 * xs
    elif kind == "spike":  # zero but for a 6x6 patch whose pixels all sample one point
        u, v = np.zeros_like(xs + ys), np.zeros_like(xs + ys)
        u[10:16, 10:16] = 20.3 - xs[:, 10:16]
        v[10:16, 10:16] = 12.3 - ys[10:16]
    else:
        return np.random.default_rng(seed).uniform(-kind, kind, (b, 2, ho, wo)).astype(np.float32)
    flow = np.stack(np.broadcast_arrays(u, v)).astype(np.float32)
    return np.repeat(flow[None], b, axis=0)


def _taps(flow: np.ndarray, h: int, w: int, stride: int):
    """Every tap of every output pixel in float32 as the kernel computes them: corners ``(cx, cy)``,
    ``inside`` [4,B,ho,wo], and the fractions ``(wx, wy)`` [B,ho,wo]."""
    ho, wo = flow.shape[2:]
    x = (np.arange(wo, dtype=np.float32) * np.float32(stride))[None, None, :] + flow[:, 0]
    y = (np.arange(ho, dtype=np.float32) * np.float32(stride))[None, :, None] + flow[:, 1]
    x0, y0 = np.floor(x), np.floor(y)
    cx = np.stack([x0, x0 + 1, x0, x0 + 1])
    cy = np.stack([y0, y0, y0 + 1, y0 + 1])
    inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
    return cx, cy, inside, x - x0, y - y0


CASES = [  # b, h, w, stride, flow
    (2, 37, 53, 1, "zero"), (2, 37, 53, 2, "zero"), (2, 40, 70, 1, "smooth"), (1, 64, 96, 2, "smooth"),
    (2, 37, 53, 1, 8.0), (2, 37, 53, 2, 8.0), (2, 45, 67, 1, 30.0), (1, 64, 96, 2, 30.0),
    (2, 37, 53, 1, "out"), (1, 33, 65, 2, "out"), (2, 40, 70, 1, "zoom"), (1, 64, 96, 2, "zoom"),
    (1, 9, 130, 1, 40.0), (2, 40, 70, 1, "spike"), (1, 40, 70, 2, "spike"), (1, 1, 1, 1, 0.5),
]


@pytest.mark.parametrize("b,h,w,stride,kind", CASES)
def test_every_candidate_lies_in_its_rectangles_box(b, h, w, stride, kind):
    ho, wo = warp.out_hw(h, w, stride)
    flow = _flow(kind, b, ho, wo, h, w, stride, seed=h + w + stride)
    rule = warp.owner_rects(torch.from_numpy(flow), h, w, stride)
    cx, cy, inside, _, _ = _taps(flow, h, w, stride)
    nry, nrx = warp.owner_grid(h, w)
    assert rule.n_cand.shape == (b, nry, nrx)
    oy, ox = np.meshgrid(np.arange(ho), np.arange(wo), indexing="ij")
    for bi in range(b):
        for ry in range(nry):
            for rx in range(nrx):
                in_r = inside[:, bi] & (cx[:, bi] // warp.OWNER_W == rx) & (cy[:, bi] // warp.OWNER_H == ry)
                cand = in_r.any(0)
                n = int(cand.sum())
                assert int(rule.n_cand[bi, ry, rx]) == n
                on = np.zeros((h, w), np.int64)  # taps on each element of the rectangle
                np.add.at(on, (cy[:, bi][in_r].astype(np.int64), cx[:, bi][in_r].astype(np.int64)), 1)
                assert int(rule.max_taps[bi, ry, rx]) == on.max()
                assert bool(rule.slow[bi, ry, rx]) == (n > warp.OWNER_CAP or on.max() > warp.OWNER_KMAX)
                if n:
                    assert not bool(rule.empty[bi, ry, rx])
                    x0, x1, y0, y1 = (int(t[bi, ry, rx]) for t in (rule.x0, rule.x1, rule.y0, rule.y1))
                    assert 0 <= x0 <= x1 < wo and 0 <= y0 <= y1 < ho
                    assert (ox[cand] >= x0).all() and (ox[cand] <= x1).all()
                    assert (oy[cand] >= y0).all() and (oy[cand] <= y1).all()
    assert warp.slow_rectangles(torch.from_numpy(flow), h, w, stride) == int(rule.slow.sum())


@pytest.mark.parametrize("b,h,w,stride,kind", [c for c in CASES if c[4] != 0.5])
def test_owner_partition_reproduces_the_plain_gradient(b, h, w, stride, kind):
    """Each rectangle summed over its box (float64, its own taps only) is the plain g_img there; each
    pixel with a tap inside the map has one anchor, its corner clamped into the map, which is one
    of its taps and lies in a rectangle whose box holds the pixel; g_flow is zero for the others."""
    ho, wo = warp.out_hw(h, w, stride)
    c = 3
    flow = _flow(kind, b, ho, wo, h, w, stride, seed=2 * h + w)
    rng = np.random.default_rng(h * w + stride)
    img, gout = rng.standard_normal((b, c, h, w)), rng.standard_normal((b, c, ho, wo))
    want_img, want_flow = warp.backwarp_bwd_plain(torch.from_numpy(img), torch.from_numpy(flow),
                                                  torch.from_numpy(gout), stride)
    rule = warp.owner_rects(torch.from_numpy(flow), h, w, stride)
    cx, cy, inside, fx, fy = _taps(flow, h, w, stride)
    wx, wy = fx.astype(np.float64), fy.astype(np.float64)
    wgt = np.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy])
    nry, nrx = warp.owner_grid(h, w)
    got = np.full((b, c, h, w), np.nan)
    anchors = np.zeros((b, ho, wo), np.int64)
    ax, ay = np.maximum(cx[0], 0), np.maximum(cy[0], 0)
    for bi in range(b):
        for ry in range(nry):
            for rx in range(nrx):
                ys, xs = slice(ry * warp.OWNER_H, (ry + 1) * warp.OWNER_H), slice(rx * warp.OWNER_W, (rx + 1) * warp.OWNER_W)
                acc = np.zeros((c, h, w))
                if not bool(rule.empty[bi, ry, rx]):
                    x0, x1, y0, y1 = (int(t[bi, ry, rx]) for t in (rule.x0, rule.x1, rule.y0, rule.y1))
                    for k in range(4):
                        sel = inside[k, bi, y0:y1 + 1, x0:x1 + 1]
                        tx = cx[k, bi, y0:y1 + 1, x0:x1 + 1][sel].astype(np.int64)
                        ty = cy[k, bi, y0:y1 + 1, x0:x1 + 1][sel].astype(np.int64)
                        mine = (tx // warp.OWNER_W == rx) & (ty // warp.OWNER_H == ry)
                        vals = (gout[bi, :, y0:y1 + 1, x0:x1 + 1][:, sel] * wgt[k, bi, y0:y1 + 1, x0:x1 + 1][sel])[:, mine]
                        np.add.at(acc, (slice(None), ty[mine], tx[mine]), vals)
                    held = np.zeros((ho, wo), bool)
                    held[y0:y1 + 1, x0:x1 + 1] = True
                    anchored = (inside[:, bi].any(0) & (ax[bi] // warp.OWNER_W == rx) & (ay[bi] // warp.OWNER_H == ry))
                    assert (held | ~anchored).all()
                    anchors[bi] += anchored
                got[bi, :, ys, xs] = acc[:, ys, xs]
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want_img.numpy(), rtol=0, atol=1e-12)
    has_tap = inside.any(0)
    assert (anchors == has_tap).all()  # one anchor each, none without a tap inside
    is_tap = np.zeros_like(has_tap)
    for k in range(4):  # the anchor is one of the pixel's taps inside the map
        is_tap |= (cx[k] == ax) & (cy[k] == ay) & inside[k]
    assert (is_tap == has_tap).all()
    assert (want_flow.numpy().transpose(1, 0, 2, 3)[:, ~has_tap] == 0).all()


def test_zoom_and_spike_send_rectangles_down_the_slow_path():
    h, w, stride = 40, 70, 1
    flow = torch.from_numpy(_flow("zoom", 2, h, w, h, w, stride, 0))
    rule = warp.owner_rects(flow, h, w, stride)
    assert 0 < int(rule.slow.sum()) < rule.slow.numel()
    smooth = torch.from_numpy(_flow(30.0, 2, h, w, h, w, stride, 1))
    assert warp.slow_rectangles(smooth, h, w, stride) == 0
    spike = warp.owner_rects(torch.from_numpy(_flow("spike", 1, h, w, h, w, stride, 0)), h, w, stride)
    assert int(spike.slow.sum()) == 1 and int(spike.n_cand.max()) <= warp.OWNER_CAP  # by its taps alone


def test_owner_constants_match_the_source():
    src = SRC.read_text()
    rw, rh = map(int, re.search(r"constexpr int RW = (\d+), RH = (\d+);", src).groups())
    nt = int(re.search(r"constexpr int NT = (\d+);  // threads a block", src).group(1))
    slots = int(re.search(r"constexpr int SLOTS = (\d+);", src).group(1))
    kmax = int(re.search(r"constexpr int KMAX = (\d+);", src).group(1))
    assert "constexpr int CAP = NT * SLOTS;" in src
    assert (rw, rh, nt * slots, kmax) == (warp.OWNER_W, warp.OWNER_H, warp.OWNER_CAP, warp.OWNER_KMAX)
    # the pre-pass's tiles are a warp's 32 pixels of one row: the float32 form's tiles
    assert (warp.TILE_W, warp.TILE_H) == (32, 1) and "const int tx0 = (tile - oy * ntx) * 32" in src
    assert "cudaMemsetAsync(boxes, 0x7f," in src and "constexpr int EMPTY = 0x7f7f7f7f;" in src


def test_slow_rect_counter_is_one_int32_per_device():
    cpu = torch.device("cpu")
    counter = warp.slow_rect_counter(cpu)
    assert counter.dtype == torch.int32 and counter.shape == (1,)
    assert warp.slow_rect_counter(cpu) is counter
    assert counter is not warp.out_of_window_counter(cpu)


# -- on the card -------------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,stride,kind", [
    (2, 37, 53, 1, 30.0), (2, 37, 53, 2, 30.0), (2, 40, 70, 1, "zoom"), (1, 64, 96, 2, "zoom"),
    (2, 40, 70, 1, "smooth"), (1, 33, 65, 2, "out"), (1, 9, 130, 1, 40.0), (2, 40, 70, 1, "spike")])
@pytest.mark.parametrize("c", [5, 7, 33])
def test_kernel_boxes_count_and_gradients_follow_the_rule(cuda, monkeypatch, b, h, w, stride, kind, c):
    ho, wo = warp.out_hw(h, w, stride)
    flow = torch.from_numpy(_flow(kind, b, ho, wo, h, w, stride, seed=w + c)).to(cuda).to(BF16)
    g = torch.Generator(device=cuda).manual_seed(c + h)
    img = torch.randn(b, c, h, w, device=cuda, generator=g).to(BF16)
    gout = torch.randn(b, c, ho, wo, device=cuda, generator=g).to(BF16)
    seen = []
    real_empty = torch.empty

    def spy_empty(*args, **kw):  # the boxes the wrapper allocates for the launch
        t = real_empty(*args, **kw)
        seen.append(t)
        return t

    outs = []
    counter = warp.slow_rect_counter(cuda)
    for _ in range(2):
        g_img, g_flow = torch.full_like(img, 3.0), torch.full_like(flow, 3.0)
        counter.zero_()
        with monkeypatch.context() as m:
            m.setattr(torch, "empty", spy_empty)
            warp._launch_bwd(img, flow, gout, stride, g_img, g_flow)
        torch.cuda.synchronize()
        outs.append((g_img, g_flow, int(counter.item())))
    rule = warp.owner_rects(flow.float(), h, w, stride)
    boxes = seen[0]
    empty = boxes[..., 0] == 0x7F7F7F7F
    assert torch.equal(empty.cpu(), rule.empty.cpu())
    for j, (name, sign) in enumerate((("x0", 1), ("x1", -1), ("y0", 1), ("y1", -1))):
        got = (sign * boxes[..., j].long())[~empty]
        assert torch.equal(got.cpu(), getattr(rule, name)[~rule.empty].cpu()), name
    assert outs[0][2] == outs[1][2] == int(rule.slow.sum())
    for a, bb in zip(outs[0][:2], outs[1][:2]):  # deterministic
        assert torch.equal(a.view(torch.int16), bb.view(torch.int16))
    want_img, want_flow = warp.backwarp_bwd_plain(img.float(), flow.float(), gout.float(), stride)
    tol = 1e-5 * max(float(want_img.abs().max()), float(want_flow.abs().max()), 1.0)
    for got, want in ((outs[0][0], want_img), (outs[0][1], want_flow)):
        ref = want.to(BF16).float()
        _, e = torch.frexp(ref.abs())
        ulp = torch.ldexp(torch.ones_like(ref), e - 8)
        assert not bool(((got.float() - ref).abs() > ulp + tol).any())
