"""The bf16 cost-volume kernels' tensor-core decomposition, replayed on the CPU.

``csrc/corr49_bf16.cu`` (forward) and ``csrc/corr49_bwd_bf16.cu`` (backward)
compute the cost volume and its two gradients as banded products on
``mma.sync.m16n8k16`` (``csrc/corr_mma.cuh``). Here their index arithmetic is
replayed in torch, lane by lane and with the sources' own constants: the
staged layout (the TMA boxes from column x0-8, the window shifted by 4
columns into buffers whose channels are padded apart),
which lane holds which row and column of the A, B and C fragments, ldmatrix
with and without ``.trans``, the band written from the accumulators to the
staged output, the backward's band fragments G and G^T built from g's staged
windows, the zero-padding of K past C, and the persistent grid's job
schedule. Memory the kernels never write is NaN in the replay, so a read of
it shows. The replay runs in float32 on float32 maps and is held to
``corr49_plain`` / ``corr49_bwd_plain`` within atol 1e-5 (1e-5 * max|plain|
for the gradients, the tolerance of tests/test_torch_corr_tiles.py), at the
level shapes of a 128^2 pair and at the edge shapes.
"""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from piv_liteflownet_tpu_torch.ops import correlation as corr

CSRC = Path(corr.__file__).resolve().parents[1] / "csrc"
BF16 = torch.bfloat16


def _constants(*names: str) -> dict:
    """The namespace-level ``constexpr int`` of the sources, evaluated in order."""
    env = {}
    for name in names:
        for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", (CSRC / name).read_text(), re.M):
            env[key] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


FWD = _constants("corr_tiles.cuh", "corr49_bf16.cu")
BWD = _constants("corr_tiles.cuh", "corr49_bwd_bf16.cu")

# -- m16n8k16 fragments (PTX ISA) and ldmatrix --------------------------------------------

LANE = torch.arange(32)
GL, TL = LANE // 4, LANE % 4
# A: register r (0..3), half e: row g + 8 (r & 1), column 2t + e + 8 (r >> 1)
A_ROW = torch.stack([GL + 8 * (r & 1) for r in range(4) for e in range(2)], 1)     # [32, 8]
A_COL = torch.stack([2 * TL + e + 8 * (r >> 1) for r in range(4) for e in range(2)], 1)
# B: register r (0..1), half e: k = 2t + e + 8r, n = g
B_K = torch.stack([2 * TL + e + 8 * r for r in range(2) for e in range(2)], 1)      # [32, 4]
B_N = torch.stack([GL for r in range(2) for e in range(2)], 1)
# C: value i (0..3): row g + 8 (i >> 1), column 2t + (i & 1)
C_ROW = torch.stack([GL + 8 * (i >> 1) for i in range(4)], 1)                       # [32, 4]
C_COL = torch.stack([2 * TL + (i & 1) for i in range(4)], 1)


def test_fragment_maps_cover_each_element_once():
    for rows, cols, shape in ((A_ROW, A_COL, (16, 16)), (B_K, B_N, (16, 8)), (C_ROW, C_COL, (16, 8))):
        hits = torch.zeros(shape, dtype=torch.int64)
        hits.index_put_((rows.flatten(), cols.flatten()), torch.ones(rows.numel(), dtype=torch.int64),
                        accumulate=True)
        assert (hits == 1).all()


def ldsm_x4(smem: torch.Tensor, addr: torch.Tensor, trans: bool) -> torch.Tensor:
    """ldmatrix.x4 on ``smem [..., n]`` with lane row addresses ``addr [W, 32]`` (values): the four
    registers of each lane, two values each -> [..., W, 32, 4, 2]. Lane l gets row l/4, columns
    2(l%4), 2(l%4)+1 of matrix i (rows given by lanes 8i..8i+7), or with ``trans`` column l/4 of
    rows 2(l%4), 2(l%4)+1."""
    idx = torch.empty(*addr.shape, 4, 2, dtype=torch.int64)
    for i in range(4):
        for e in range(2):
            if trans:
                idx[:, :, i, e] = addr[:, 8 * i + 2 * TL + e] + GL
            else:
                idx[:, :, i, e] = addr[:, 8 * i + GL] + 2 * TL + e
    assert bool((addr % 8 == 0).all()), "ldmatrix rows are 16 bytes aligned"
    return smem[..., idx]


def mma(d: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d + a b on fragments: d [..., 32, 4], a [..., 32, 4, 2] (A's registers), b [..., 32, 2, 2]."""
    am = torch.zeros(*a.shape[:-3], 16, 16, dtype=a.dtype)
    am[..., A_ROW.flatten(), A_COL.flatten()] = a.flatten(-3)
    bm = torch.zeros(*b.shape[:-3], 16, 8, dtype=b.dtype)
    bm[..., B_K.flatten(), B_N.flatten()] = b.flatten(-3)
    return d + (am @ bm)[..., C_ROW, C_COL]


def test_mma_replay_is_a_matrix_product():
    gen = torch.Generator().manual_seed(0)
    am, bm = torch.randn(16, 16, generator=gen), torch.randn(16, 8, generator=gen)
    a = am[A_ROW, A_COL].view(32, 4, 2)
    b = bm[B_K, B_N].view(32, 2, 2)
    got = mma(torch.zeros(32, 4), a, b)
    want = am @ bm
    torch.testing.assert_close(got, want[C_ROW, C_COL])


# -- staging ---------------------------------------------------------------------------------

def _windows(t: torch.Tensor, nx: int, ny: int, left: int, width: int, top: int, height: int, cpad: int,
             ty: int = FWD["TY"]):
    """Per tile of 32 x ``ty`` (origins x0 = 32k - 4, y0 = ty l), rows y0-top .. and columns x0-left
    .. of ``t [B,C,H,W]``, zero outside the map and past C (channels padded to a multiple of
    ``cpad``) -> [B, C', ny, nx, height, width]."""
    b, c, h, w = t.shape
    m = 16  # margin beyond any window's reach
    p = F.pad(t, (m, nx * 32 - w + width + m, m, ny * ty - h + height + m))[:, :, m - top:, m - 4 - left:]
    p = F.pad(p, (0, 0, 0, 0, 0, -c % cpad))
    return p.unfold(2, height, ty).unfold(3, width, 32)[:, :, :ny, :nx]


def _spacer(win: torch.Tensor) -> torch.Tensor:
    """A box's row past the kernel's need (it spaces the channels; TMA fills it, the edge path
    leaves it), NaN: never read."""
    return torch.cat([win, torch.full_like(win[..., :1, :], float("nan"))], -2)


def _flat_channels(win: torch.Tensor, stride: int) -> torch.Tensor:
    """Staged channels ``[..., C', rows, cols]`` laid out ``stride`` values apart, the gap NaN
    (never written by the kernel) -> [..., C' * stride]."""
    flat = win.flatten(-2)
    gap = torch.full((*flat.shape[:-1], stride - flat.shape[-1]), float("nan"))
    return torch.cat([flat, gap], -1).flatten(-2)


def _stages(t: torch.Tensor, nx: int, ny: int, top: int, rows: int, box_rows: int, cc: int, stride: int,
            ty: int) -> torch.Tensor:
    """A box per tile and channel group: columns x0-4 .. x0+35, rows y0-top .. (``rows`` of them,
    then NaN spacers up to ``box_rows``), channels ``stride`` apart -> [B, ny, nx, groups, CC * stride]."""
    b = t.shape[0]
    win = _windows(t, nx, ny, 4, 40, top, rows, cc, ty)                       # [B, C', ny, nx, rows, 40]
    for _ in range(box_rows - rows):
        win = _spacer(win)
    win = win.permute(0, 2, 3, 1, 4, 5)
    win = win.reshape(b, win.shape[1], win.shape[2], -1, cc, box_rows, 40)
    return _flat_channels(win, stride)


def _warp_lane(nw: int):
    """[nw, 32] warp and lane indices, and each warp's segment and row pair."""
    warp = torch.arange(nw)[:, None].expand(nw, 32)
    lane = LANE[None].expand(nw, 32)
    return warp, lane, warp & 3, warp >> 2


def _crop(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The tiles' pixels (x from -4) cut to the map."""
    return t[..., :h, 4:4 + w]


# -- the forward ------------------------------------------------------------------------------

def emulate_forward(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """``csrc/corr49_bf16.cu`` lane by lane: per tile and channel group, the stage (f2's box, f1's
    box), each warp's A fragment (pairs of f1 values read from the stage) and, per window row ri, a
    B fragment (ldmatrix.trans of f2) and two mma; then the band into the warp's staged output and
    its rows out."""
    k = FWD
    b, c, h, w = f1.shape
    nx, ny = -(-(w + 4) // k["TX"]), -(-h // k["TY"])
    cc, ty, nw, rpn = k["CC"], k["TY"], k["NW"], k["RP"]
    groups = -(-c // cc)
    stages = torch.cat([_stages(f2, nx, ny, k["MD"], ty + 2 * k["MD"], k["SH"], cc, k["F2C"], ty),
                        _stages(f1, nx, ny, 0, ty, k["F1H"], cc, k["F1C"], ty)], -1)
    assert stages.shape[-1] == k["STAGE"] and k["F1_OFF"] == cc * k["F2C"]

    warp, lane, seg, rp = _warp_lane(nw)
    g_, t = lane >> 2, lane & 3
    bw, f1c = k["BW"], k["F1C"]
    a_off = k["F1_OFF"] + 2 * t * f1c + 2 * rp * bw + 4 + 8 * seg + g_
    b_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * k["F2C"] + 2 * rp * bw + 8 * seg + 8 * (lane >> 4)
    acc = torch.zeros(b, ny, nx, 8, 2, nw, 32, 4)                           # [..., ri, n, warp, lane, 4]
    for grp in range(groups):
        st = stages[:, :, :, grp]
        # a[r] = (channel 2t, 2t+1 (+8)) of pixel g in row h = r & 1
        a = torch.stack([torch.stack([st[..., a_off + (r & 1) * bw + (r >> 1) * 8 * f1c + e * f1c]
                                      for e in range(2)], -1) for r in range(4)], -2)  # [..., NW, 32, 4, 2]
        for ri in range(8):
            bq = ldsm_x4(st, b_off + ri * bw, trans=True)
            for n in range(2):
                acc[:, :, :, ri, n] = mma(acc[:, :, :, ri, n], a, bq[..., 2 * n:2 * n + 2, :])

    # the band into each row pair's staged output [d][pixel][row]: so = s*OP + 2(8seg + g), plus a
    # constant of (dyi, n, e); row 0's value and row 1's of the same displacement in one 32-bit store
    op, tx = k["OP"], k["TX"]
    s = 2 * t - g_
    base = s * op + 2 * (8 * seg + g_)                                      # [16 warps, 32 lanes]
    staged = torch.full((b, ny, nx, rpn, k["ROUT"]), float("nan"))          # [..., row pair, ROUT]
    written = torch.zeros(rpn, k["ROUT"], dtype=torch.int64)
    for dyi in range(k["ND"]):
        for n in range(2):
            for e in range(2):
                dxc = 8 * n + e - 1
                live = ((dxc + s) >= 0) & ((dxc + s) < k["ND"])
                idx = base + (dyi * k["ND"] + dxc) * op
                assert bool((idx % 2 == 0).all()), "32-bit stores"
                for wi in range(nw):
                    rp_, sel = wi >> 2, idx[wi][live[wi]]
                    staged[..., rp_, sel] = acc[:, :, :, dyi, n, wi, :, e][..., live[wi]] / c
                    staged[..., rp_, sel + 1] = acc[:, :, :, dyi + 1, n, wi, :, 2 + e][..., live[wi]] / c
                    written[rp_].index_add_(0, torch.cat([sel, sel + 1]), torch.ones(2 * len(sel), dtype=torch.int64))
    planes = written.view(rpn, k["NDISP"], op)
    assert (planes[..., :2 * tx] == 1).all() and (planes[..., 2 * tx:] == 0).all()
    # row pair rp holds the tile's 32 pixels x rows 2rp, 2rp+1 of each plane
    out = staged.view(b, ny, nx, rpn, k["NDISP"], op)[..., :2 * tx].reshape(b, ny, nx, rpn, k["NDISP"], tx, 2)
    out = out.permute(0, 4, 1, 3, 6, 2, 5).reshape(b, k["NDISP"], ny * ty, nx * 32)
    return _crop(out, h, w)


# -- the backward -----------------------------------------------------------------------------

def _g_windows(g: torch.Tensor, nx: int, ny: int, o: int) -> torch.Tensor:
    """g's staged windows of every tile for output ``o``, in 7 boxes of 7 planes (GG values apart,
    planes GP apart): rows y0 .. y0+7 (o = 0) or shifted by -dy (o = 1), then the NaN spacer,
    columns x0-4 .. x0+35 -> [B, ny, nx, 7 * GG]."""
    k = BWD
    boxes = []
    for dyi in range(k["ND"]):
        top = dyi - k["MD"] if o else 0
        win = _spacer(_windows(g[:, dyi * k["ND"]:(dyi + 1) * k["ND"]], nx, ny, 4, k["BW"], top, k["TY"], 1, k["TY"]))
        flat = win.permute(0, 2, 3, 1, 4, 5).flatten(-3)                      # [B, ny, nx, 7 * GP]
        boxes.append(torch.cat([flat, torch.full((*flat.shape[:-1], k["GG"] - flat.shape[-1]), float("nan"))], -1))
    return torch.cat(boxes, -1)


def _band_fragments(sg: torch.Tensor, o: int) -> torch.Tensor:
    """``band_fragments<O>``: per warp and lane, bq[ri][h][kh] (two values each) from g's windows
    ``sg [..., 7*GG]`` -> [..., 8, 2, NW, 32, 2, 2] (ri, h, warp, lane, kh, e)."""
    k = BWD
    gp, gg, bw, nd = k["GP"], k["GG"], k["BW"], k["ND"]
    warp, lane, seg, rp = _warp_lane(k["NW"])
    g_, t = lane >> 2, lane & 3
    s = 2 * t - g_
    base = (s * gp + 2 * rp * bw + 4 + 8 * seg + g_) if o == 0 else (-s * gp + 2 * rp * bw + 8 * seg + 2 * t)
    out = torch.zeros(*sg.shape[:-1], 8, 2, k["NW"], 32, 2, 2)
    for ri in range(8):
        for hh in range(2):
            if not 0 <= ri - hh < nd:
                continue
            for kh in range(2):
                for e in range(2):
                    dxc = 8 * kh + e - 1
                    live = ((dxc + s) >= 0) & ((dxc + s) < nd)
                    if o == 0:
                        idx = base + (ri - hh) * gg + dxc * gp + hh * bw
                    else:
                        idx = base + (6 + hh - ri) * gg + (6 - dxc) * gp + hh * bw + 8 * kh + e
                    vals = sg[..., idx.clamp(0, sg.shape[-1] - 1)]
                    out[..., ri, hh, :, :, kh, e] = torch.where(live, vals, torch.zeros(()))
    return out


def emulate_backward(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor):
    """``csrc/corr49_bwd_bf16.cu`` lane by lane: per tile and output, the band fragments from g's
    windows; per channel group, per window row ri, an A fragment (ldmatrix of the map's box) and an
    mma for each output row whose displacement row exists; each lane's two pixel pairs stored."""
    k = BWD
    b, c, h, w = f1.shape
    nx, ny = -(-(w + 4) // k["TX"]), -(-h // k["TY"])
    cc, nw, rpn = k["CC"], k["NW"], k["RP"]
    groups = -(-c // cc)
    warp, lane, seg, rp = _warp_lane(nw)
    a_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * k["MC"] + 2 * rp * k["BW"] + 8 * seg + 8 * (lane >> 4)
    outs = []
    for o, m in ((0, f2), (1, f1)):
        stages = _stages(m, nx, ny, k["MD"], k["TY"] + 2 * k["MD"], k["SH"], cc, k["MC"], k["TY"])
        assert stages.shape[-1] == k["STAGE"]
        bq = _band_fragments(_g_windows(g, nx, ny, o), o)                     # [B, ny, nx, 8, 2, 16, 32, 2, 2]
        assert not bool(bq.isnan().any()), "a band fragment read g outside its staged windows"
        res = torch.full((b, groups * cc, ny * k["TY"], nx * k["TX"]), float("nan"))
        written = torch.zeros(groups * cc, dtype=torch.int64)
        for grp in range(groups):
            acc = torch.zeros(b, ny, nx, 2, nw, 32, 4)
            for ri in range(8):
                a = ldsm_x4(stages[:, :, :, grp], a_off + ri * k["BW"], trans=False)
                for hh in range(2):
                    if 0 <= ri - hh < k["ND"]:
                        acc[:, :, :, hh] = mma(acc[:, :, :, hh], a, bq[:, :, :, ri, hh])
            # lane: channels g, g+8, pixels 8seg + 2t (+1) of the tile (from x0), row 2rp + h, as a pair
            # into its row pair's staged output [16 channels][2 rows][32 pixels] (channels OC apart),
            # whose rows the row pair then stores
            oc, tx = k["OC"], k["TX"]
            rout = torch.full((b, ny, nx, rpn, k["ROUT"]), float("nan"))
            for hh in range(2):
                for mm in range(2):
                    idx = ((lane >> 2) + 8 * mm) * oc + hh * tx + 8 * seg + 2 * (lane & 3)
                    for wi in range(nw):
                        for e in range(2):
                            rout[..., wi >> 2, idx[wi] + e] = acc[:, :, :, hh, wi, :, 2 * mm + e] / c
            pieces = rout.view(b, ny, nx, rpn, cc, oc)[..., :2 * tx].reshape(b, ny, nx, rpn, cc, 2, tx)
            th = k["TY"]
            for ty in range(ny):
                for tx_ in range(nx):
                    blk = pieces[:, ty, tx_].permute(0, 2, 1, 3, 4).reshape(b, cc, th, tx)
                    res[:, grp * cc:(grp + 1) * cc, ty * th:(ty + 1) * th, tx_ * tx:(tx_ + 1) * tx] = blk
                    written[grp * cc:(grp + 1) * cc] += 1
        assert (written == ny * nx).all() and not bool(res[:, :c].isnan().any())
        outs.append(_crop(res[:, :c], h, w))
    return outs[0], outs[1]


LEVELS_128 = [(1, 64, 64, 64), (1, 64, 32, 32), (1, 64, 16, 16), (1, 96, 16, 16), (1, 128, 8, 8),
              (1, 192, 4, 4)]  # piv v1's cost volumes of a 128^2 pair (stride 2 at levels 1-3)
EDGES = [(2, 1, 9, 16), (1, 3, 37, 53), (2, 5, 10, 37), (1, 192, 8, 8), (1, 4, 1, 1), (2, 3, 2, 3),
         (1, 16, 13, 40)]


def _inputs(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    b, c, h, w = shape
    return (torch.randn(shape, generator=gen), torch.randn(shape, generator=gen),
            torch.randn((b, corr.NDISP, h, w), generator=gen))


@pytest.mark.parametrize("shape", LEVELS_128 + EDGES)
def test_forward_mma_replayed_matches_plain(shape):
    f1, f2, _ = _inputs(shape, sum(shape))
    got = emulate_forward(f1, f2)
    torch.testing.assert_close(got, corr.corr49_plain(f1, f2), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", LEVELS_128 + EDGES)
def test_backward_mma_replayed_matches_plain(shape):
    f1, f2, g = _inputs(shape, sum(shape) + 1)
    want1, want2 = corr.corr49_bwd_plain(f1, f2, g)
    got1, got2 = emulate_backward(f1, f2, g)
    for got, want in ((got1, want1), (got2, want2)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(float(want.abs().max()), 1.0))


# -- the persistent schedule and the tile rule --------------------------------------------------

def _jobs(n_tiles, blocks, per_tile):
    """Each block's jobs as (local tile, kind): tiles block, block + blocks, ..."""
    out = []
    for blk in range(blocks):
        mine = (n_tiles - 1 - blk) // blocks + 1 if n_tiles > blk else 0
        out.append([(j // per_tile, j % per_tile) for j in range(mine * per_tile)])
    return out


@pytest.mark.parametrize("n_tiles,blocks", [(1, 1), (7, 3), (40, 132), (300, 132)])
def test_persistent_walk_covers_every_tile_once(n_tiles, blocks):
    """Block b walks tiles b, b + blocks, ... (``tiles_of_block``): every tile once."""
    blocks = min(blocks, n_tiles)
    seen = []
    for blk in range(blocks):
        mine = (n_tiles - 1 - blk) // blocks + 1 if n_tiles > blk else 0
        seen += [blk + lt * blocks for lt in range(mine)]
    assert sorted(seen) == list(range(n_tiles))


def test_bf16_tile_rule_mirrors_the_kernel_sources():
    for src, backward in ((FWD, False), (BWD, True)):
        assert (src["TX"], src["TY"]) == (corr.BWD_TILE if backward else corr.FWD_TILE)
        assert (src["CC"], src["NS"]) == (corr.BF16_STAGE_CHANNELS, corr.BF16_STAGES)
        assert src["SMEM"] == corr.smem_bytes(backward, BF16) <= corr.SMEM_LIMIT
        plan = corr.tile_plan(2, 37, 53, backward, dtype=BF16)
        assert plan.smem == src["SMEM"] and plan.tile == (src["TX"], src["TY"]) and plan.edge
        assert plan.x0 == [-4, 28] and plan.n_tiles == (2 if backward else 1) * 2 * 2 * 5
    for name, backward in (("corr49_bf16.cu", False), ("corr49_bwd_bf16.cu", True)):
        stated = re.search(r"constexpr int SMEM = .*// ([\d,]+) bytes", (CSRC / name).read_text())
        assert int(stated.group(1).replace(",", "")) == corr.smem_bytes(backward, BF16)
    # ldmatrix's 8 rows of a matrix, one per staged channel, on distinct 16-byte bank groups
    for stride in (FWD["F2C"], BWD["MC"]):
        assert len({(2 * stride * i) % 128 for i in range(8)}) == 8
    # the lanes' reads of f1 (channel 2t of pixel g): a 4-way conflict (channels 640 bytes apart,
    # the source's choice: no spare row); of g (plane offset s = 2t-g, pixel g): distinct banks
    lane = torch.arange(32)
    words = (2 * (lane & 3) * FWD["F1C"] + (lane >> 2)) // 2
    assert len(set((words % 32).tolist())) == 4 and FWD["F1H"] == FWD["TY"]
    s_ = 2 * (lane & 3) - (lane >> 2)
    words = s_ * BWD["GP"] // 2 + (lane >> 2) // 2
    assert len(set((words % 32).tolist())) == len(set(zip(s_.tolist(), ((lane >> 2) // 2).tolist())))
