"""The tensor-core form of the conv chain (``ops/conv_chain.py``), on the CPU.

The kernel runs layers of more than 8 output channels on the tensor cores at
float32 accuracy with the 3xTF32 split. What surrounds it is Python and is
held here: ``tf32_split`` (the weights' split, and the rounding of PTX
``cvt.rna.tf32.f32`` that the kernel applies to the activations) against a
float64 reference; a 3xTF32 emulation of the chain (three ``F.conv2d`` on
split operands per layer, as the kernel multiplies) against
``conv_chain_plain`` within the card's tolerance of 1e-5 * max|plain|, which
single-pass TF32 misses; ``layer_plan`` for every stack the model sends to
the chain; and the packed weights' layout, read back with the kernel's own
index arithmetic. Inputs are made with numpy from seeds.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from piv_liteflownet_tpu_torch import hui_liteflownet, piv_liteflownet
from piv_liteflownet_tpu_torch.ops import conv_chain as cc
from piv_liteflownet_tpu_torch.ops.nn import leaky_relu

CHAIN_RTOL = 1e-5  # the card's tolerance: atol 1e-5 * max|plain| (chip_smoke.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- tf32_split ---------------------------------------------------------------------

def _split_values(seed):
    """Float32 values: log-uniform magnitudes, exact ties of the TF32 rounding, values just
    below and above powers of two (rounding carries into the exponent), and zero."""
    rng = np.random.default_rng(seed)
    wide = rng.standard_normal(4000) * 10.0 ** rng.uniform(-20, 20, 4000)
    bits = rng.standard_normal(2000).astype(np.float32).view(np.int32)
    ties = ((bits & ~0x1FFF) | 0x1000).view(np.float32)
    pow2 = 2.0 ** rng.integers(-60, 60, 1000)
    near = np.concatenate([pow2 * (1 - 2.0 ** -12), pow2 * (1 - 2.0 ** -24), pow2 * (1 + 2.0 ** -11),
                           -pow2 * (1 - 2.0 ** -13)])
    return np.concatenate([wide, ties, near, [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)


def _rna_reference(x):
    """Round float32 ``x`` to 11 significant bits, to nearest, ties away from zero, in float64."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)  # |x| = m * 2^e, m in [0.5, 1)
    ulp = np.ldexp(1.0, e - 11)
    return (np.sign(x64) * np.floor(np.abs(x64) / ulp + 0.5) * ulp).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_rounds_to_nearest_ties_away(seed):
    x = _split_values(seed)
    hi, lo = (t.numpy() for t in cc.tf32_split(torch.from_numpy(x)))
    assert not (hi.view(np.int32) & 0x1FFF).any() and not (lo.view(np.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi, _rna_reference(x))
    np.testing.assert_array_equal(lo, _rna_reference((x.astype(np.float64) - hi).astype(np.float32)))
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()


def test_tf32_split_ties_go_away_from_zero():
    one_ulp = 2.0 ** -10  # the TF32 unit of [1, 2)
    x = torch.tensor([1 + one_ulp / 2, 1 + 3 * one_ulp / 2, -(1 + one_ulp / 2), 2 - one_ulp / 4],
                     dtype=torch.float32)
    hi, lo = cc.tf32_split(x)
    assert hi.tolist() == [1 + one_ulp, 1 + 2 * one_ulp, -(1 + one_ulp), 2.0]
    assert (hi + lo).tolist() == x.tolist()


# -- the 3xTF32 chain against the float32 chain -----------------------------------------

def _model_stack(version, kind):
    """The level-1 NetE-S or NetE-R stack of piv v1 as the model initialises it."""
    model = piv_liteflownet(seed=0, version=version, device="cpu")
    stack = model.NetE_S[0].conv_S if kind == "S" else model.NetE_R[0].conv_R
    convs = [m for m in stack if isinstance(m, torch.nn.Conv2d)]
    last_linear = not isinstance(stack[-1], torch.nn.LeakyReLU)
    return [c.weight.detach() for c in convs], [c.bias.detach() for c in convs], last_linear


def _chain_emulated(parts, weights, biases, last_linear, passes):
    """The chain with the kernel's arithmetic: on the tensor-core path each conv is the sum of
    ``passes`` TF32 products (3: lo*hi + hi*lo + hi*hi; 1: hi*hi), the FFMA path in float32."""
    plans = cc.layer_plan([(w.shape[2], w.shape[1], w.shape[0]) for w in weights])
    x = torch.cat(parts, 1)
    for i, (plan, w, b) in enumerate(zip(plans, weights, biases)):
        pad = plan.k // 2
        if plan.path == "ffma":
            y = F.conv2d(x, w, b, 1, pad)
        else:
            (xh, xl), (wh, wl) = cc.tf32_split(x), cc.tf32_split(w)
            y = F.conv2d(xh, wh, None, 1, pad)
            if passes == 3:
                y = F.conv2d(xl, wh, None, 1, pad) + F.conv2d(xh, wl, None, 1, pad) + y
            y = y + b.view(1, -1, 1, 1)
        x = leaky_relu(y) if i < len(weights) - 1 or not last_linear else y
    return x


@pytest.mark.parametrize("kind,parts_c", [("S", [64, 64, 2]), ("R", [1, 2, 128])])
def test_3xtf32_emulation_holds_the_card_tolerance(kind, parts_c):
    weights, biases, last_linear = _model_stack(1, kind)
    assert sum(parts_c) == weights[0].shape[1]
    rng = np.random.default_rng(len(kind) + sum(parts_c))
    parts = [torch.from_numpy((rng.standard_normal((1, c, 24, 40)) * 0.5).astype(np.float32))
             for c in parts_c]
    with torch.no_grad():
        want = cc.conv_chain_plain(parts, weights, biases, last_linear)
        three = _chain_emulated(parts, weights, biases, last_linear, passes=3)
        one = _chain_emulated(parts, weights, biases, last_linear, passes=1)
    tol = CHAIN_RTOL * float(want.abs().max())
    err3, err1 = float((three - want).abs().max()), float((one - want).abs().max())
    assert err3 <= tol, (err3, tol)
    # single-pass TF32 is another function: the tolerance tells the two apart
    assert err1 >= 10 * tol and err1 >= 10 * err3, (err1, err3, tol)


# -- layer_plan ----------------------------------------------------------------------------

def _chain_stacks(model):
    """(name, [(k, cin, cout)]) of every stack that ``_run_stack`` may send to the chain."""
    for i, level in enumerate(model.cfg.levels):
        for name, stack in (("M", model.NetE_M[i].conv_M), ("S", model.NetE_S[i].conv_S),
                            ("R", model.NetE_R[i].conv_R)):
            convs = [m for m in stack if isinstance(m, torch.nn.Conv2d)]
            yield f"{name} level {level}", [(c.kernel_size[0], c.in_channels, c.out_channels) for c in convs]


@pytest.mark.parametrize("family,version", [("piv", 1), ("piv", 2), ("hui", 1), ("hui", 2)])
def test_layer_plan_of_every_model_stack(family, version):
    build = piv_liteflownet if family == "piv" else hui_liteflownet
    model = build(seed=0, version=version, device="cpu")
    n_stacks = 0
    for name, shapes in _chain_stacks(model):
        plans = cc.layer_plan(shapes)
        off = 0
        for plan, (k, cin, cout) in zip(plans, shapes):
            assert (plan.k, plan.cin, plan.cout) == (k, cin, cout)
            assert plan.path == ("mma" if cout >= 16 else "ffma"), (name, plan)
            assert plan.smem <= 232448, (name, plan)
            if plan.path == "mma":
                assert plan.bn in cc.MMA_WIDTHS and plan.cin_pad % 8 == 0 and plan.cin_pad >= cin
                assert plan.cout_pad % plan.bn == 0 and plan.cout_pad - cout < plan.bn
                assert plan.woff % 4 == 0  # the kernel copies weights 16 bytes at a time
            assert plan.woff >= off and plan.boff == plan.woff + plan.weight_elems
            off = plan.boff + cout
        n_stacks += 1
    assert n_stacks == 3 * len(model.cfg.levels)


@pytest.mark.parametrize("k,cout,bn", [(1, 128, 64), (3, 128, 64), (3, 96, 64), (3, 64, 64),
                                       (3, 32, 32), (3, 24, 32), (3, 12, 32), (5, 128, 64),
                                       (7, 128, 32), (7, 9, 32), (7, 8, 0), (3, 2, 0)])
def test_layer_plan_tile_rule(k, cout, bn):
    """The widest channel tile no wider than cout rounded up to 32 whose two stages fit."""
    (plan,) = cc.layer_plan([(k, 130, cout)])
    assert plan.bn == bn
    assert plan.smem <= cc.SMEM_BUDGET
    if bn and bn < max(cc.MMA_WIDTHS) and bn < -(-cout // 32) * 32:
        assert cc._smem(k, bn + 32, cout) > cc.SMEM_BUDGET  # a wider tile would not fit


# -- the packed weights -----------------------------------------------------------------------

def _stack(seed, shapes):
    rng = np.random.default_rng(seed)
    weights = [torch.from_numpy((rng.standard_normal((cout, cin, k, k)) / np.sqrt(k * k * cin))
                                .astype(np.float32)) for k, cin, cout in shapes]
    biases = [torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32)) for _, _, cout in shapes]
    return weights, biases


def _read_back(packed, plan):
    """The weight ``[Cout,Cin,k,k]`` as the kernel reads it: hi and lo of stage (nb, chunk, ky),
    row (kx, hl, n) of 16 input channels at woff + stage * K*2*BN*16 + row * 16."""
    k, bn, ck = plan.k, plan.bn, cc.MMA_CHUNK
    nch, nnb = plan.cin_pad // ck, plan.cout_pad // bn
    w = np.zeros((2, plan.cout_pad, plan.cin_pad, k, k), np.float32)
    flat = packed.numpy()
    for nb in range(nnb):
        for c in range(nch):
            for ky in range(k):
                stage = plan.woff + ((nb * nch + c) * k + ky) * k * 2 * bn * ck
                for kx in range(k):
                    for hl in range(2):
                        for n in range(bn):
                            row = stage + ((kx * 2 + hl) * bn + n) * ck
                            w[hl, nb * bn + n, c * ck:(c + 1) * ck, ky, kx] = flat[row:row + ck]
    return w


@pytest.mark.parametrize("shapes", [
    [(3, 20, 24), (7, 24, 2)],                # padded cin and cout, then the FFMA path
    [(3, 49, 96), (3, 96, 12), (3, 12, 8)],   # 96 channels in two tiles; 12 on the tensor cores
    [(5, 18, 128), (1, 128, 40)],             # k 5; k 1
])
def test_packed_weights_read_back_with_the_kernel_index(shapes):
    weights, biases = _stack(len(shapes), shapes)
    packed, plans = cc._packed(weights, biases)
    assert packed.numel() == plans[-1].boff + plans[-1].cout
    for plan, wt, bs in zip(plans, weights, biases):
        np.testing.assert_array_equal(packed[plan.boff:plan.boff + plan.cout].numpy(), bs.numpy())
        if plan.path == "ffma":
            got = packed[plan.woff:plan.woff + plan.weight_elems].view(plan.cin, plan.k, plan.k, plan.cout)
            assert torch.equal(got.permute(3, 0, 1, 2), wt)
            continue
        hl = _read_back(packed, plan)
        hi, lo = cc.tf32_split(wt)
        np.testing.assert_array_equal(hl[0, :plan.cout, :plan.cin], hi.numpy())
        np.testing.assert_array_equal(hl[1, :plan.cout, :plan.cin], lo.numpy())
        assert not hl[:, plan.cout:].any() and not hl[:, :, plan.cin:].any()  # zero padding
        np.testing.assert_allclose(hl[0, :plan.cout, :plan.cin] + hl[1, :plan.cout, :plan.cin], wt.numpy(),
                                   rtol=2.0 ** -22, atol=0)


def test_launch_passes_the_plan_and_nhwc_scratch(monkeypatch):
    """``_launch`` hands the kernel each layer's (k, cout, bn, woff, boff) and two NHWC scratch
    buffers of the widest intermediate, its channels rounded up to 4 (read through a fake
    ``kernels.launch``)."""
    import ctypes

    weights, biases = _stack(3, [(3, 20, 24), (3, 24, 6), (3, 6, 2)])
    parts = [torch.zeros(2, 12, 5, 7), torch.zeros(2, 8, 5, 7)]
    seen = {}

    def fake_launch(fn, op, device, parts_p, part_c, n_parts, plan_p, n_layers, wpack, buf0, buf1, out,
                    b, h, w, last_linear):
        seen.update(fn=fn, plan=list((ctypes.c_int * (5 * n_layers)).from_address(plan_p)),
                    part_c=list((ctypes.c_int * n_parts).from_address(part_c)),
                    scratch_floats=(buf1 - buf0) // 4, size=(b, h, w), last_linear=last_linear)

    monkeypatch.setattr(cc.kernels, "launch", fake_launch)
    cc._launch(parts, weights, biases, True, torch.empty(2, 2, 5, 7))
    plans = cc._packed(weights, biases)[1]
    assert seen["fn"] == "pivk_conv_chain_f32" and seen["part_c"] == [12, 8]
    assert seen["plan"] == [v for p in plans for v in (p.k, p.cout, p.bn, p.woff, p.boff)]
    assert [p.bn for p in plans] == [32, 0, 0]
    assert seen["scratch_floats"] == 2 * 5 * 7 * 24 and seen["size"] == (2, 5, 7) and seen["last_linear"] == 1
