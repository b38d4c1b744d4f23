"""The bf16 form of the conv chain (``ops/conv_chain.py``, ``pivk_conv_chain_bf16``) against the
JAX package's TPU kernel in bf16.

The TPU kernel ``conv_chain_pallas`` computes in its input's dtype: in bf16 it sums every tap,
channel and part in float32, adds the bias and applies the LeakyReLU in float32 and rounds once
per layer to bf16 (``pallas_conv.py:216-271``). ``conv_chain_plain`` follows that rule in bf16.
Here, on the CPU, from seeded numpy inputs cast to bf16 on both sides:

- ``conv_chain_plain`` in bf16 against ``conv_chain_pallas(..., interpret=True)`` in bf16 at the
  shapes of ``CASES`` (tests/test_torch_conv_chain.py). A single conv agrees within one bf16 ulp
  of the JAX value, elementwise (its float32 sums differ in order only). A stack agrees within
  one bf16 epsilon (2^-7) of max |JAX|, and at most ``MAX_DIFFERING`` of its values differ: an
  intermediate that rounds the other way moves the next layer's sums (measured: 71 of 10752 and
  83 of 3200 values, one or two ulps);
- bf16 piv v1 with ``conv_impl="chain"`` through ``PLAIN_OPS`` against JAX's bf16 forward with
  its chain on the TPU kernel in interpret mode, at 128x128 (levels 32, 64 and 128 take the
  chain). On the CPU, JAX's ``_use_pallas_convs`` says no because the backend is not a TPU, so
  the test patches, for itself only, that gate to its shape rule and ``conv_chain_pallas`` to
  ``interpret=True``. The port's seeded weights go to JAX through JAX's ``from_torch_state_dict``,
  and both sides cast the same numpy arrays to bf16. Tolerance: 3 % of the float32 flow's max
  |flow|, as in tests/test_torch_bf16.py (measured: the two bf16 flows 1.2 % of it apart, each
  0.9 % from the float32 flow);
- through faked kernels: a bf16 chain model launches ``pivk_conv_chain_bf16`` only, with a bf16
  output and bf16 scratch; the bf16 packed weights read back through the kernel's B-descriptor
  image; the bf16 plan and tensor maps of every NetE stack fit the shared memory a block may take
  and TMA's limits; and the kernel's addressing and order, emulated on the CPU, agree with the
  plain chain.

The ``gpu`` tests hold the kernel to its plain version on the card.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch import hui_liteflownet, kernels, piv_liteflownet
from piv_liteflownet_tpu_torch.inference import estimate
from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS
from piv_liteflownet_tpu_torch.ops import conv_chain as cc
from piv_liteflownet_tpu_torch.ops import correlation, rgb_warp, warp
from test_torch_conv_chain import CASES, _chain, _to_torch

BF16 = torch.bfloat16
EPS = float(torch.finfo(BF16).eps)  # 2^-7
FLOW_TOL = 0.03                     # of the float32 flow's max |flow|
MAX_DIFFERING = 0.05                # share of a stack's values that may differ from JAX's
CSRC = Path(cc.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes run at once; one torch thread each."""
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


def _bf16(tensors):
    return [t.to(BF16) for t in tensors]


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |t| (t bf16 values held in float32)."""
    _, e = torch.frexp(t.abs())
    return torch.ldexp(torch.ones_like(t), e - 8)


# -- the plain bf16 chain against the TPU kernel in bf16 ------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_plain_bf16_matches_tpu_kernel_interpret_bf16(name):
    import jax.numpy as jnp

    from piv_liteflownet_tpu.ops.pallas_conv import conv_chain_pallas

    shapes, parts_c, (b, h, w), last_linear, _ = CASES[name]
    parts, weights, biases = _chain(len(name), shapes, parts_c, b, h, w)
    want = conv_chain_pallas(*([jnp.asarray(a, jnp.bfloat16) for a in arrays] for arrays in (parts, weights, biases)),
                             last_linear=last_linear, tile_h=16, tile_w=24, interpret=True)
    assert want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.asarray(want).astype(np.float32)).permute(0, 3, 1, 2)
    got = cc.conv_chain_plain(*(_bf16(ts) for ts in _to_torch(parts, weights, biases)), last_linear)
    assert got.dtype == BF16 and got.shape == want.shape
    err = (got.float() - want).abs()
    if len(shapes) == 1:
        assert bool((err <= _bf16_ulp(want)).all()), f"{name}: {float(err.max()):.3e} beyond one ulp"
    else:
        assert float(err.max()) <= EPS * float(want.abs().max()), name
        assert int((err > 0).sum()) <= MAX_DIFFERING * err.numel(), f"{name}: {int((err > 0).sum())} differ"


# -- the model in bf16 with the chain against JAX's bf16 forward on the TPU kernel --------------

def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    img1 = rng.random((1, h, w, 3), dtype=np.float32)
    img2 = np.clip(img1 + 0.05 * rng.standard_normal((1, h, w, 3), dtype=np.float32), 0, 1)
    return img1, img2


def test_bf16_chain_model_matches_jax_bf16_forward_on_the_tpu_kernel(monkeypatch):
    import jax
    import jax.numpy as jnp

    from piv_liteflownet_tpu.models import liteflownet as jlfn
    from piv_liteflownet_tpu.models.convert import from_torch_state_dict
    from piv_liteflownet_tpu.ops import pallas_conv

    calls = []
    interpret = pallas_conv.conv_chain_pallas

    def on_the_kernel(parts, *args, **kw):
        calls.append(parts[0].shape[1:3])
        assert parts[0].dtype == jnp.bfloat16
        return interpret(parts, *args, **kw, interpret=True)

    # JAX's gate without its backend check, and its kernel in interpret mode: this test only
    monkeypatch.setattr(jlfn, "_use_pallas_convs",
                        lambda cfg, shape: cfg.conv_impl == "pallas" and shape[1] >= 32 and shape[2] >= 32)
    monkeypatch.setattr(pallas_conv, "conv_chain_pallas", on_the_kernel)
    # the port's seeded weights carried to JAX (initialising JAX's own takes ~20 s here)
    model = piv_liteflownet(seed=5, version=1, device="cpu", conv_impl="chain")
    cfg = model.cfg
    jcfg = jlfn.ModelConfig(version=1, starting_scale=cfg.starting_scale, lowest_level=cfg.lowest_level,
                            rgb_mean=cfg.rgb_mean, conv_impl="pallas")
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    jparams = {k: v.astype(jnp.bfloat16) for k, v in from_torch_state_dict(jcfg, state).items()}
    img1, img2 = _pair(128, 128, seed=1)
    want = jax.jit(lambda p, a, b: jlfn.forward(p, a, b, jcfg, precision=None))(
        jparams, jnp.asarray(img1, jnp.bfloat16), jnp.asarray(img2, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    assert calls == [(s, s) for s in (32, 64, 128) for _ in range(3)]
    want = np.asarray(want).astype(np.float32)

    x1, x2 = (torch.from_numpy(a).permute(0, 3, 1, 2).contiguous() for a in (img1, img2))
    with torch.no_grad():
        f32 = model(x1, x2, PLAIN_OPS).permute(0, 2, 3, 1).numpy()
        got = model.to(BF16)(x1.to(BF16), x2.to(BF16), PLAIN_OPS)
    assert got.dtype == BF16
    got = got.float().permute(0, 2, 3, 1).numpy()
    tol = FLOW_TOL * float(np.abs(f32).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"port bf16 chain vs JAX bf16 chain: {err:.3e} > {tol:.3e}"
    assert float(np.abs(got - f32).max()) <= tol and float(np.abs(want - f32).max()) <= tol


# -- through faked kernels -----------------------------------------------------------------------

def _fake_bf16_kernels(monkeypatch):
    """Route every op through its kernel path on the CPU. The chain's ``_launch`` runs as it is up
    to ``kernels.launch``, which records the entry point and its arguments, and then the plain
    version fills the output; the other ops' ``_launch`` run their plain versions."""
    launches = []
    real_launch = cc._launch

    def record(fn, op, device, *args):
        launches.append((fn, args))

    def chain_launch(parts, weights, biases, last_linear, out):
        real_launch(parts, weights, biases, last_linear, out)
        launches[-1] += (out.dtype, tuple(parts[0].shape[2:]))
        out.copy_(cc.conv_chain_plain(parts, weights, biases, last_linear))

    monkeypatch.setattr(kernels, "on_cuda", lambda op, *tensors: True)
    monkeypatch.setattr(kernels, "launch", record)
    monkeypatch.setattr(cc, "_launch", chain_launch)
    monkeypatch.setattr(correlation, "_launch", lambda f1, f2, out: out.copy_(correlation.corr49_plain(f1, f2)))
    monkeypatch.setattr(warp, "_launch", lambda img, flow, s, out: out.copy_(warp.backwarp_plain(img, flow, s)))
    monkeypatch.setattr(rgb_warp, "_launch",
                        lambda a, b, f, out: out.copy_(rgb_warp.rgb_warp_norm_plain(a, b, f)))
    for mod in (correlation, warp, rgb_warp, cc):
        monkeypatch.setattr(mod, "launches", 0)
        monkeypatch.setattr(mod, "bf16_launches", 0)
    return launches


@pytest.mark.parametrize("version,levels,counts", [(1, [32, 64, 128], (6, 11, 6)), (2, [32, 64], (5, 9, 5))])
def test_bf16_chain_model_launches_only_the_bf16_chain(monkeypatch, version, levels, counts):
    """At 128x128 a bf16 chain model launches ``pivk_conv_chain_bf16`` for the M, S and R stacks of
    every level of at least 32x32, coarse to fine, each with a bf16 output and bf16 scratch, and
    no ``_f32`` form of any kernel; the flow is bf16 and equals the plain-ops forward's."""
    launches = _fake_bf16_kernels(monkeypatch)
    model = piv_liteflownet(seed=0, version=version, device="cpu", conv_impl="chain").to(BF16)
    img1, img2 = _pair(128, 128, seed=3)
    got = estimate(model, img1, img2, tensor=True)
    assert got.dtype == BF16
    assert [fn for fn, *_ in launches] == ["pivk_conv_chain_bf16"] * len(levels) * 3
    assert [size for *_, size in launches] == [(s, s) for s in levels for _ in range(3)]
    for fn, args, dtype, (h, w) in launches:
        buf0, buf1 = args[6], args[7]
        # the scratch of the widest intermediate or repacked input, 8 bf16 a pixel apart
        assert dtype == BF16 and (buf1 - buf0) % (2 * 8 * h * w) == 0 and buf1 - buf0 >= 2 * 128 * h * w
    assert (cc.bf16_launches, cc.launches) == (len(levels) * 3, 0)
    assert tuple(m.bf16_launches for m in (correlation, warp, rgb_warp)) == counts
    assert tuple(m.launches for m in (correlation, warp, rgb_warp)) == (0, 0, 0)
    want = estimate(model, img1, img2, tensor=True, ops=PLAIN_OPS)
    assert torch.equal(got, want)


def test_bf16_launch_passes_the_bf16_plan_and_scratch(monkeypatch):
    """``_launch`` hands the bf16 entry point each layer's (k, cout, bn, woff, boff) of the bf16
    plan, the bf16 packed weights, and two NHWC scratch buffers of the widest of the intermediates
    and the repacked input, channels rounded up to 8 bf16."""
    seen = {}

    def fake_launch(fn, op, device, parts_p, part_c, n_parts, plan_p, n_layers, wpack, buf0, buf1, out,
                    b, h, w, last_linear):
        seen.update(fn=fn, plan=list((ctypes.c_int * (5 * n_layers)).from_address(plan_p)),
                    part_c=list((ctypes.c_int * n_parts).from_address(part_c)), wpack=wpack,
                    scratch_bytes=buf1 - buf0, size=(b, h, w), out=out)

    monkeypatch.setattr(cc.kernels, "launch", fake_launch)
    weights, biases = (_bf16(ts) for ts in _to_torch(*_chain(3, [(3, 20, 24), (3, 24, 6), (3, 6, 2)],
                                                              [20], 1, 4, 4))[1:])
    parts = [torch.zeros(2, 13, 5, 7, dtype=BF16), torch.zeros(2, 7, 5, 7, dtype=BF16)]
    out = torch.empty(2, 2, 5, 7, dtype=BF16)
    cc._launch(parts, weights, biases, True, out)
    packed, plans = cc._packed(weights, biases)
    assert seen["fn"] == "pivk_conv_chain_bf16" and seen["part_c"] == [13, 7]
    assert packed.dtype == BF16 and seen["wpack"] == packed.data_ptr() and seen["out"] == out.data_ptr()
    assert seen["plan"] == [v for p in plans for v in (p.k, p.cout, p.bn, p.woff, p.boff)]
    assert [p.bn for p in plans] == [32, 0, 0] and plans[0].woff == 0 and plans[1].woff % 8 == 0
    # widest: the 20 input channels rounded up to 24 (the intermediates: 24 and 6 -> 8)
    assert seen["scratch_bytes"] == 2 * 2 * 5 * 7 * 24 and seen["size"] == (2, 5, 7)


def _read_back_bf16(packed, plan):
    """The weight ``[Cout,Cin,k,k]`` as the bf16 form's B descriptor reads it: stage (nb, chunk, ky)
    at woff + stage * K*BN*16, tap kx's image at + kx * BN*16, output channel n and input channel ci
    of the chunk at + ``b_image_offset(n, ci)`` (8x8 core matrices, no swizzle)."""
    k, bn, ck = plan.k, plan.bn, cc.MMA_CHUNK
    nch, nnb = plan.cin_pad // ck, plan.cout_pad // bn
    w = np.zeros((plan.cout_pad, plan.cin_pad, k, k), np.float32)
    flat = packed.float().numpy()
    n, ci = np.meshgrid(np.arange(bn), np.arange(ck), indexing="ij")
    image = np.vectorize(cc.b_image_offset)(n, ci)
    for nb in range(nnb):
        for c in range(nch):
            for ky in range(k):
                stage = plan.woff + ((nb * nch + c) * k + ky) * k * bn * ck
                for kx in range(k):
                    w[nb * bn:(nb + 1) * bn, c * ck:(c + 1) * ck, ky, kx] = flat[stage + kx * bn * ck + image]
    return w


@pytest.mark.parametrize("shapes", [
    [(3, 20, 24), (7, 24, 2)],                # padded cin and cout, then the FFMA path
    [(3, 49, 96), (3, 96, 12), (3, 12, 8)],   # a 96-channel tile; 12 on the tensor cores
    [(5, 18, 128), (1, 128, 40), (7, 40, 64)],  # k 5, k 1, and k 7 with 64 channels (bf16 only)
])
def test_bf16_packed_weights_read_back_with_the_kernel_index(shapes):
    rng = np.random.default_rng(len(shapes))
    weights = [torch.from_numpy(rng.standard_normal((cout, cin, k, k)).astype(np.float32)).to(BF16)
               for k, cin, cout in shapes]
    biases = [torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(BF16) for _, _, cout in shapes]
    packed, plans = cc._packed(weights, biases)
    assert packed.dtype == BF16 and packed.numel() == plans[-1].boff + plans[-1].cout
    for plan, wt, bs in zip(plans, weights, biases):
        assert plan.dtype == BF16 and plan.woff % 8 == 0
        assert torch.equal(packed[plan.boff:plan.boff + plan.cout], bs)
        if plan.path == "ffma":
            got = packed[plan.woff:plan.woff + plan.weight_elems].view(plan.cin, plan.k, plan.k, plan.cout)
            assert torch.equal(got.permute(3, 0, 1, 2), wt)
            continue
        assert plan.weight_elems == plan.cin_pad * plan.k ** 2 * plan.cout_pad  # no lo half
        back = _read_back_bf16(packed, plan)
        np.testing.assert_array_equal(back[:plan.cout, :plan.cin], wt.float().numpy())
        assert not back[plan.cout:].any() and not back[:, plan.cin:].any()  # zero padding
    if shapes[-1] == (7, 40, 64):  # the f32 form takes BN 32 at k 7, the bf16 form fits 64
        assert plans[-1].bn == 64 and cc.layer_plan([shapes[-1]])[0].bn == 32


def _model_stacks(model):
    for i, level in enumerate(model.cfg.levels):
        for name, stack in (("M", model.NetE_M[i].conv_M), ("S", model.NetE_S[i].conv_S),
                            ("R", model.NetE_R[i].conv_R)):
            convs = [m for m in stack if isinstance(m, torch.nn.Conv2d)]
            yield f"{name} level {level}", [(c.kernel_size[0], c.in_channels, c.out_channels) for c in convs]


FAMILIES = [("piv", 1), ("piv", 2), ("hui", 1), ("hui", 2)]


@pytest.mark.parametrize("family,version", FAMILIES)
def test_bf16_plan_of_every_model_stack_fits(family, version):
    """Every NetE stack's bf16 plan fits ``SMEM_BUDGET`` with one block of 384 threads per SM (the
    bf16 form's two consumer warpgroups and its producer; 228 KB an SM, 1 KB of it reserved per
    block, under 1 KB static), and every tensor-core layer of the models (128, 96, 64 or 32
    channels) gets a channel tile as wide as its channels: no channel computed in vain."""
    build = piv_liteflownet if family == "piv" else hui_liteflownet
    model = build(seed=0, version=version, device="cpu")
    for name, shapes in _model_stacks(model):
        plans = cc.layer_plan(shapes, BF16)
        for plan, (k, cin, cout) in zip(plans, shapes):
            assert (plan.k, plan.cin, plan.cout, plan.dtype) == (k, cin, cout, BF16)
            assert plan.path == ("mma" if cout >= 16 else "ffma"), (name, plan)
            assert plan.smem <= cc.SMEM_BUDGET and plan.smem + 2048 <= 233472, (name, plan)
            assert plan.woff % 8 == 0
            if plan.bn:
                assert plan.bn == cout and plan.bn in cc.MMA_WIDTHS_BF16, (name, plan)


def test_bf16_channel_tile_rule():
    """The bf16 tile makes the fewest channel tiles of those that fit, and of those computes the
    fewest channels; a 7x7 layer of 128 channels does not fit BN 128 (the weight ring of 7 taps)
    and takes two tiles of 64."""
    def bn(k, cout):
        return cc.layer_plan([(k, 16, cout)], BF16)[0].bn

    assert [bn(3, c) for c in (128, 96, 64, 32, 100, 48, 24, 12, 200)] == [128, 96, 64, 32, 128, 64, 32, 32, 128]
    assert bn(7, 128) == 64 and cc._smem(7, 128, 128, BF16) > cc.SMEM_BUDGET
    assert all(cc._smem(k, b, 0, BF16) <= cc.SMEM_BUDGET
               for k in cc.KERNEL_SIZES for b in cc.MMA_WIDTHS_BF16 if (k, b) != (7, 128))


@pytest.mark.parametrize("family,version", FAMILIES)
def test_tma_box_of_every_model_stack(family, version):
    """The tensor map of every bf16 tensor-core layer's input at the stack's sizes of a 1024^2 pair,
    as ``cuTensorMapEncodeTiled`` requires it: strides multiples of 16 bytes (and below 2^40), every
    box dimension 1-256, the inner box 16 bytes, the box within the shared-memory plane the kernel
    stages it into; the channels are the layer's input channels."""
    build = piv_liteflownet if family == "piv" else hui_liteflownet
    model = build(seed=0, version=version, device="cpu")
    n_layers = 0
    for (name, shapes), level in zip(_model_stacks(model), [lv for lv in model.cfg.levels for _ in range(3)]):
        h = w = 1024 >> (level - 1)
        for plan in cc.layer_plan(shapes, BF16):
            if not plan.bn:
                continue
            n_layers += 1
            tma = cc.tma_box(plan, 1, h, w)
            assert tma.dims == (plan.cin, w, h, 1), (name, plan)
            assert all(s % 16 == 0 and s < 2 ** 40 for s in tma.strides), (name, tma)
            assert tma.strides[0] >= 2 * plan.cin and tma.strides[1] == w * tma.strides[0]
            assert all(1 <= d <= 256 for d in tma.box) and tma.box[0] * 2 == 16, (name, tma)
            assert tma.box[1] == cc.TC_COLS and tma.box[2] == cc.tile_rows(plan.bn) + plan.k - 1
            plane = (tma.box[1] * tma.box[2] + 8) * 16  # the staged plane: the box and 8 spare pixels
            assert 2 * cc.TC_STAGES[0] * plane < plan.smem
    assert n_layers == len(model.cfg.levels) * (5 + 5 + 6 if version == 2 else 3 + 3 + 6)


def test_smem_agrees_with_the_source():
    """The shared memory that ``layer_plan`` computes for each form is what the kernel's source
    states: the f32 form's for a 3x3 layer with BN 64, the bf16 form's for a 3x3 layer with BN 128."""
    src = re.sub(r"\s*\n//\s*", " ", (CSRC / "conv_chain.cu").read_text())  # the comments' lines joined
    f32 = re.search(r"([\d,]+) bytes for a 3x3 layer with BN 64 \(one block", src)
    bf16 = re.search(r"([\d,]+) bytes of dynamic shared memory for a 3x3 layer with BN 128", src)
    assert f32 and bf16
    assert int(f32.group(1).replace(",", "")) == cc._smem(3, 64, 64) == 143040
    assert int(bf16.group(1).replace(",", "")) == cc._smem(3, 128, 128, BF16) == 147200


def _emulate_tensor_core_layer(x, wt, bias, act):
    """One bf16 tensor-core conv as the kernel computes it, on the CPU: per tile (``tile_rows(bn)``
    rows x ``tile_cols(k)`` columns) and channel tile, each 16-channel chunk staged as two 8-channel
    planes in the TMA box's order (zeros off the map and past cin, NaN in the 8 spare pixels), the
    packed weights staged per (chunk, ky); then, in the kernel's (chunk, ky, kx) order, every m64
    block's A read through the no-swizzle descriptor's addressing (start 64 (row + ky) + kx pixels,
    8-pixel core matrices 128 bytes apart, the second channel half a plane on) and B through
    ``b_image_offset``, the products summed in float32; the bias and the LeakyReLU in float32 and
    one rounding, the valid columns kept. ``x`` ``[B,cin,H,W]``, ``wt``, ``bias`` bf16."""
    bsz, cin, h, w = x.shape
    cout, _, k, _ = wt.shape
    packed, (plan,) = cc._packed([wt], [bias])
    bn, ck, cols = plan.bn, cc.MMA_CHUNK, cc.TC_COLS
    th, tw, pad = cc.tile_rows(bn), cc.tile_cols(k), k // 2
    tma = cc.tma_box(plan, bsz, h, w)
    rows = tma.box[2]
    plane = rows * cols * 8 + 8 * 8  # bf16 of a staged plane
    nch = plan.cin_pad // ck
    flat = packed.float()
    # the descriptors' element offsets: A row i, channel kk from the block's start; B (n, kk)
    i, kk = np.meshgrid(np.arange(64), np.arange(ck), indexing="ij")
    a_off = torch.from_numpy((i // 8) * 64 + (kk // 8) * plane + (i % 8) * 8 + kk % 8)
    n, kk = np.meshgrid(np.arange(bn), np.arange(ck), indexing="ij")
    b_off = torch.from_numpy(np.vectorize(cc.b_image_offset)(n, kk))
    nhwc = torch.zeros(bsz, h, w, tma.strides[0] // 2)
    nhwc[..., :cin] = x.float().permute(0, 2, 3, 1)
    out = torch.zeros(bsz, cout, h, w)
    for b in range(bsz):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                for nb in range(plan.cout_pad // bn):
                    acc = torch.zeros(th * cols, bn)
                    for c in range(nch):
                        stage = torch.full((2 * plane,), float("nan"))
                        for half in range(2):  # the two TMA boxes of the chunk
                            box = torch.zeros(rows, cols, 8)
                            for r in range(rows):
                                for q in range(cols):
                                    gy, gx, c0 = y0 - pad + r, x0 - pad + q, c * ck + 8 * half
                                    if 0 <= gy < h and 0 <= gx < w and c0 < cin:
                                        box[r, q, :min(8, cin - c0)] = nhwc[b, gy, gx, c0:min(c0 + 8, cin)]
                            stage[half * plane:half * plane + rows * cols * 8] = box.reshape(-1)
                        for ky in range(k):
                            wstage = plan.woff + ((nb * nch + c) * k + ky) * k * bn * ck
                            for kx in range(k):
                                bmat = flat[wstage + kx * bn * ck + b_off].T  # [16, bn]
                                for m in range(th):  # the m64 blocks of both consumer warpgroups
                                    amat = stage[((m + ky) * cols + kx) * 8 + a_off]
                                    acc[m * cols:(m + 1) * cols] += amat @ bmat
                    v = acc + torch.cat([bias.float(), torch.zeros(plan.cout_pad - cout)])[nb * bn:(nb + 1) * bn]
                    v = (torch.where(v < 0, 0.1 * v, v) if act else v).to(BF16).float()
                    v = v.view(th, cols, bn)[:min(th, h - y0), :min(tw, w - x0), :min(bn, cout - nb * bn)]
                    out[b, nb * bn:nb * bn + v.shape[2], y0:y0 + v.shape[0], x0:x0 + v.shape[1]] = v.permute(2, 0, 1)
    return out.to(BF16)


@pytest.mark.parametrize("k,cout", [(1, 40), (3, 100), (5, 24), (7, 72)])
def test_cpu_emulation_of_the_tensor_core_layer_matches_plain(k, cout):
    """The kernel's addressing and order, emulated on the CPU at 23x37 with two parts of 13 and 7
    channels (cin 20: a second chunk mostly past cin), against ``conv_chain_plain`` in bf16: within
    one bf16 ulp plus 1e-5 * max|plain| elementwise, the card's tolerance (float32 sums of up to 980
    products in another order, one rounding each; near zero, where the sums cancel, the order moves
    a value by more than its own ulp: measured 3 of 61,272 values at k 7). The four cases
    take the four channel tiles: BN 64 (one tile of 40), 128 (100), 32 (24), 96 (72 at k 7)."""
    rng = np.random.default_rng(k)
    parts = [torch.from_numpy(rng.standard_normal((1, c, 23, 37)).astype(np.float32)).to(BF16) for c in (13, 7)]
    wt = torch.from_numpy((rng.standard_normal((cout, 20, k, k)) / (3 * k)).astype(np.float32)).to(BF16)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1).to(BF16)
    plan = cc.layer_plan([(k, 20, cout)], BF16)[0]
    assert plan.bn == {1: 64, 3: 128, 5: 32, 7: 96}[k]
    got = _emulate_tensor_core_layer(torch.cat(parts, 1), wt, bias, act=True)
    want = cc.conv_chain_plain(parts, [wt], [bias], last_linear=False)
    assert not torch.isnan(got.float()).any()
    err = (got.float() - want.float()).abs()
    tol = _bf16_ulp(want.float()) + 1e-5 * float(want.float().abs().max())
    assert bool((err <= tol).all()), f"{int((err > tol).sum())} values beyond one ulp"


def test_mixed_dtypes_raise():
    """A bf16 chain with float32 weights raises (float16: tests/test_torch_bf16.py)."""
    z = torch.zeros(4, 4, 8, 8)
    with pytest.raises(TypeError, match="different dtypes"):
        cc.conv_chain([z.to(BF16)], [z[:2, :4, :3, :3]], [z[0, :2, 0, 0].to(BF16)])


# -- on the card ----------------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_bf16_kernel_matches_plain(cuda, name):
    """A single conv within one bf16 ulp of the float32 plain chain on the widened operands,
    rounded, plus 1e-5 * max|plain| (the float32 kernel's tolerance); a stack's error against the
    float32 kernel on the same bf16 values within twice the plain bf16 chain's."""
    shapes, parts_c, (b, h, w), last_linear, _ = CASES[name]
    parts, weights, biases = (_bf16(ts) for ts in _to_torch(*_chain(len(name), shapes, parts_c, b, h, w),
                                                             device=cuda))
    before = cc.bf16_launches
    got = cc.conv_chain(parts, weights, biases, last_linear)
    torch.cuda.synchronize()
    assert cc.bf16_launches == before + 1 and got.dtype == BF16
    wide = [[t.float() for t in ts] for ts in (parts, weights, biases)]
    if len(shapes) == 1:
        ref = cc.conv_chain_plain(*wide, last_linear)
        rounded = ref.to(BF16).float()
        bad = (got.float() - rounded).abs() > _bf16_ulp(rounded) + 1e-5 * float(ref.abs().max())
        assert not bool(bad.any()), f"{name}: {int(bad.sum())} values beyond one ulp"
    else:
        ref = cc.conv_chain(*wide, last_linear)
        plain = cc.conv_chain_plain(parts, weights, biases, last_linear)
        err, plain_err = (float((t.float() - ref).abs().max()) for t in (got, plain))
        assert err <= 2 * plain_err, f"{name}: {err:.3e} against the plain bf16 chain's {plain_err:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("version,launches", [(1, 9), (2, 6)])
def test_bf16_chain_estimate_on_card(cuda, version, launches):
    img1, img2 = _pair(128, 160, seed=6)
    model = piv_liteflownet(seed=0, version=version, device=cuda, conv_impl="chain")
    f32 = estimate(model, img1, img2, tensor=True)
    cc.launches = cc.bf16_launches = 0
    got = estimate(model.to(BF16), img1, img2, tensor=True)
    torch.cuda.synchronize()
    assert (cc.bf16_launches, cc.launches) == (launches, 0) and got.dtype == BF16
    tol = FLOW_TOL * float(f32.abs().max())
    assert float((got.float() - f32).abs().max()) <= tol
    cpu = piv_liteflownet(seed=0, version=version, device="cpu", conv_impl="chain").to(BF16)
    assert float((got.float().cpu() - estimate(cpu, img1, img2, tensor=True).float()).abs().max()) <= tol
