"""Spatial (H-axis) sharding of the port on the CPU: the halo warp and ``estimate(spatial_mesh)``.

Gloo ranks (``parallel/mesh.py:spawn``, one torch thread each) run the rank functions of
``tests/torch_dist_workers.py``; the JAX references are computed here. At JAX's sizes
(``tests/test_spatial.py``):

- the sharded warp (halo 8, 2 and 4 ranks, strides 1 and 2, ``[2,8,64,32]``, flows up to
  5 px) equals JAX's ``backwarp`` and the port's unsharded plain warp within 1e-5 (a slab's
  sample row ``y + halo + v`` rounds to float32 at another magnitude than the frame's
  ``r Hs + y + v``: half an ulp of 64 is 3.8e-6 px; measured 1.9e-6); a flow of more than ``halo`` px on one rank alone sends every rank down the gather
  fallback, with the same result; shards below the halo gather;
- the sharded forward (piv v1 and v2, ``1x128x64``, 4 and 2 ranks, halo 8) and
  ``estimate(spatial_mesh=...)`` (``128x128``, 2 and 4 ranks; the odd ``100x96`` frame) equal
  JAX's unsharded ones within atol 5e-4, rtol 1e-3 (JAX's own tolerances), and the port's
  unsharded ones within 1e-6 px (measured: 1.5e-8 on flows of 0.018 px); the trained v1
  weights on an evalset pair (flows of a few px, so that the halo warps move) within 1e-5 px;
- each rank's exchanges move only halo rows: every record of the exchange helper received at
  most the rows it asked for, the ranks sent what they received, and the only gathers of whole
  maps are the output's and those of the warps whose shard is below the halo.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from piv_liteflownet_tpu_torch.inference import estimate
from piv_liteflownet_tpu_torch.models.convert import from_jax_params
from piv_liteflownet_tpu_torch.models.factory import PIV_V1, PIV_V2
from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS
from piv_liteflownet_tpu_torch.ops import warp
from piv_liteflownet_tpu_torch.parallel import mesh as M
from piv_liteflownet_tpu_torch.utils.flow_io import read_flow

JAX_ATOL, JAX_RTOL = 5e-4, 1e-3  # tests/test_spatial.py
WARP_JAX_ATOL = 1e-5  # tests/test_spatial.py::test_halo_backwarp_matches_gather
PORT_ATOL = 1e-6  # px: sharded against unsharded, the port's float32 plain ops
TRAINED_ATOL = 1e-5  # px: the same with the trained weights (flows of a few px)
HALO = 8
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _nchw(a):
    return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))


def _warp_inputs(stride, seed=1):
    rng = np.random.default_rng(seed)
    b, h, w, c = 2, 64, 32, 8
    img = rng.random((b, h, w, c), dtype=np.float32)
    flow = rng.uniform(-5, 5, (b, h // stride, w // stride, 2)).astype(np.float32)
    return img, flow


def _bumped(flow):
    """The flow with one v of 9 px (above HALO) in one rank's rows alone (rank 1 of 2, rank 2 of 4)."""
    out = flow.copy()
    out[0, flow.shape[1] // 2 + 1, 3, 1] = 9.0
    return out


@pytest.fixture(scope="module")
def warp_ref():
    """JAX's backwarp of each warp case, NHWC."""
    import jax.numpy as jnp

    from piv_liteflownet_tpu.ops.warp import backwarp as jbackwarp

    out = {}
    for stride in (1, 2):
        img, flow = _warp_inputs(stride)
        for bumped in (False, True):
            f = _bumped(flow) if bumped else flow
            out[stride, bumped] = np.asarray(jbackwarp(jnp.asarray(img), jnp.asarray(f), stride=stride))
    return out


def _warp_calls():
    calls = {}
    for stride in (1, 2):
        img, flow = _warp_inputs(stride)
        for bumped in (False, True):
            f = _bumped(flow) if bumped else flow
            calls[stride, bumped, HALO] = ("warp_case", (_nchw(img), _nchw(f), HALO, stride), {})
    img, flow = _warp_inputs(1)
    calls[1, False, 32] = ("warp_case", (_nchw(img), _nchw(flow), 32, 1), {})  # shards below the halo
    return calls


@pytest.fixture(scope="module")
def jax_models():
    """piv v1 and v2 (JAX, seeded) and their params in the port's layout."""
    from piv_liteflownet_tpu.models.factory import piv_liteflownet as jpiv

    out = {}
    for version, cfg in ((1, PIV_V1), (2, PIV_V2)):
        jm = jpiv(version=version, seed=3)
        state = {k: v.numpy() for k, v in from_jax_params(cfg, {k: np.asarray(v) for k, v in jm.params.items()}).items()}
        out[version] = (jm, state)
    return out


def _frames(b, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.random((b, h, w, 3), dtype=np.float32), rng.random((b, h, w, 3), dtype=np.float32)


FWD = {v: _frames(1, 128, 64, 10 + v) for v in (1, 2)}  # NHWC
EST = _frames(1, 128, 128, 7)
ODD = _frames(1, 100, 96, 8)


def _evalset_pair():
    from piv_liteflownet_tpu_torch.run import load_image

    root = REPO / "work" / "synth_run" / "evalset"
    im1, im2 = (load_image(str(root / f"00_vortex_{t}.png"))[None] for t in ("img1", "img2"))
    return im1, im2


@pytest.fixture(scope="module")
def trained_state():
    from piv_liteflownet_tpu_torch.utils.checkpoint import load_params_npz

    return {k: v.numpy() for k, v in load_params_npz(PIV_V1, str(REPO / "work/synth_run/params_final.npz")).items()}


@pytest.fixture(scope="module")
def runs(jax_models, trained_state):
    """Each rank's results of the warp and model cases over 2 and over 4 ranks."""
    tr1, tr2 = _evalset_pair()
    model_calls = {
        ("forward", 1): ("spatial_forward", (1, jax_models[1][1], _nchw(FWD[1][0]), _nchw(FWD[1][1]), HALO), {}),
        ("forward", 2): ("spatial_forward", (2, jax_models[2][1], _nchw(FWD[2][0]), _nchw(FWD[2][1]), HALO), {}),
        ("gather", 1): ("spatial_forward", (1, jax_models[1][1], _nchw(FWD[1][0]), _nchw(FWD[1][1]), HALO),
                        {"halo_warp": False}),
        ("estimate", 1): ("spatial_estimate_case", (1, jax_models[1][1], *EST), {}),
        ("odd", 1): ("spatial_estimate_case", (1, jax_models[1][1], *ODD), {}),
    }
    out = {}
    for n in (2, 4):
        calls = {**_warp_calls(), **model_calls}
        if n == 2:
            calls["trained", 1] = ("spatial_forward", (1, trained_state, _nchw(tr1), _nchw(tr2), HALO), {})
        results = M.spawn(W.many, n, list(calls.values()), axes=("spatial",), threads=1, timeout_s=300)
        out[n] = [dict(zip(calls, r)) for r in results]
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_halo_warp_matches_jax_and_the_unsharded_warp(runs, warp_ref, n, stride):
    img, flow = _warp_inputs(stride)
    plain = warp.backwarp_plain(torch.from_numpy(_nchw(img)), torch.from_numpy(_nchw(flow)), stride).numpy()
    for rank in range(n):
        got = runs[n][rank][stride, False, HALO]
        np.testing.assert_allclose(np.transpose(got["out"], (0, 2, 3, 1)), warp_ref[stride, False],
                                   atol=WARP_JAX_ATOL, rtol=WARP_JAX_ATOL)
        np.testing.assert_allclose(got["out"], plain, atol=WARP_JAX_ATOL)
        assert got["gathers"] == [] and [r[0] for r in got["halo"]] == ["halo warp"]
        # the slab's rows: HALO above and below, none past the frame's edges
        label, top, bottom, row_bytes, sent, received = got["halo"][0]
        assert (top, bottom) == (HALO if rank else 0, HALO if rank < n - 1 else 0)
        assert received == (top + bottom) * row_bytes == 2 * 8 * 32 * 4 * (top + bottom)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_a_flow_beyond_the_halo_on_one_rank_sends_every_rank_to_the_gather(runs, warp_ref, n, stride):
    """v = 9 px > HALO in one rank's rows alone: the bound is taken over all ranks, so every rank
    falls back (no rank waits in an exchange the others skipped), and the result is exact."""
    for rank in range(n):
        got = runs[n][rank][stride, True, HALO]
        assert [g[0] for g in got["gathers"]] == ["warp fallback"] and got["halo"] == []
        np.testing.assert_allclose(np.transpose(got["out"], (0, 2, 3, 1)), warp_ref[stride, True],
                                   atol=WARP_JAX_ATOL, rtol=WARP_JAX_ATOL)


def test_shards_below_the_halo_gather(runs, warp_ref):
    """4 ranks of 16 rows and a halo of 32: JAX's rule takes the gather warp."""
    for rank in range(4):
        got = runs[4][rank][1, False, 32]
        assert [g[0] for g in got["gathers"]] == ["warp gather"] and got["halo"] == []
        np.testing.assert_allclose(np.transpose(got["out"], (0, 2, 3, 1)), warp_ref[1, False],
                                   atol=WARP_JAX_ATOL, rtol=WARP_JAX_ATOL)


@pytest.fixture(scope="module")
def unsharded(jax_models, trained_state):
    """The port's unsharded plain forwards and estimates, and JAX's."""
    import jax.numpy as jnp

    from piv_liteflownet_tpu.inference import estimate as jestimate

    out = {}
    for v in (1, 2):
        jm, state = jax_models[v]
        model = W.model_from("piv", v, state)
        with torch.no_grad():
            out["forward", v] = model(*(torch.from_numpy(_nchw(a)) for a in FWD[v]), PLAIN_OPS).numpy()
        out["jax forward", v] = np.asarray(jm(jnp.asarray(FWD[v][0]), jnp.asarray(FWD[v][1])))
    model = W.model_from("piv", 1, jax_models[1][1])
    for key, frames in (("estimate", EST), ("odd", ODD)):
        out[key] = estimate(model, *frames, tensor=True, ops=PLAIN_OPS).numpy()
    out["jax estimate"] = np.asarray(jestimate(jax_models[1][0], *EST, tensor=True))
    with torch.no_grad():
        out["trained"] = W.model_from("piv", 1, trained_state)(
            *(torch.from_numpy(_nchw(a)) for a in _evalset_pair()), PLAIN_OPS).numpy()
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("version", [1, 2])
def test_spatial_forward_matches_the_unsharded_one_and_jax(runs, unsharded, n, version):
    want, jax_want = unsharded["forward", version], unsharded["jax forward", version]
    for rank in range(n):
        got = runs[n][rank]["forward", version]["flow"]
        np.testing.assert_allclose(got, want, atol=PORT_ATOL)
        np.testing.assert_allclose(np.transpose(got, (0, 2, 3, 1)), jax_want, atol=JAX_ATOL, rtol=JAX_RTOL)


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_forward_without_the_halo_warp_gathers_every_warp(runs, unsharded, n):
    """``halo_warp=False`` (JAX's ``spatial_estimate(halo_warp=False)``): every warp gathers the
    whole map (3 a level, 2 at level 6), and the flow is the unsharded one."""
    for rank in range(n):
        got = runs[n][rank]["gather", 1]
        labels = [g[0] for g in got["gathers"]]
        assert labels.count("warp gather") == 17 and labels[-1] == "output"
        assert "halo warp" not in [r[0] for r in got["halo"]]
        np.testing.assert_allclose(got["flow"], unsharded["forward", 1], atol=PORT_ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_estimate_spatial_mesh_matches_the_unsharded_estimates(runs, unsharded, n):
    for rank in range(n):
        got = runs[n][rank]["estimate", 1]
        assert got.shape == (1, 128, 128, 2)
        np.testing.assert_allclose(got, unsharded["estimate"], atol=PORT_ATOL)
        np.testing.assert_allclose(got, unsharded["jax estimate"], atol=JAX_ATOL, rtol=JAX_RTOL)


@pytest.mark.parametrize("n", [2, 4])
def test_estimate_spatial_mesh_of_an_odd_frame(runs, unsharded, n):
    """100x96 is resized to 128x96 (the next multiple of 32 x N: 128 for 2 and 4 ranks, as for
    one) and the flow back to 100x96."""
    for rank in range(n):
        got = runs[n][rank]["odd", 1]
        assert got.shape == (1, 100, 96, 2) and np.isfinite(got).all()
        np.testing.assert_allclose(got, unsharded["odd"], atol=PORT_ATOL)


def test_spatial_forward_with_trained_weights_moves_the_halo_warps(runs, unsharded):
    """The trained v1 weights on an evalset vortex (up to 2.5 px): the halo warps read rows of
    the neighbours, and the sharded flow is the unsharded one."""
    assert np.abs(unsharded["trained"]).max() > 1.0
    for rank in range(2):
        got = runs[2][rank]["trained", 1]
        np.testing.assert_allclose(got["flow"], unsharded["trained"], atol=TRAINED_ATOL)
        assert "halo warp" in [r[0] for r in got["halo"]]


@pytest.mark.parametrize("n", [2, 4])
def test_exchanges_move_only_halo_rows(runs, n):
    """The counterpart of JAX's HLO check (``tests/test_spatial.py:72-93``): in one forward
    (piv v1, 1x128x64, halo 8) each exchange received at most the rows it asked for, which are no
    more than the halo or the widest receptive field of a module, each side (9 rows: NetE-R's
    six 3x3 convs and its 7x1 dist conv at levels 1-2); the ranks sent what they received; and
    the only whole-map gathers are the output's and the warps' whose shard is below the halo."""
    sent = received = 0
    for rank in range(n):
        got = runs[n][rank]["forward", 1]
        for label, top, bottom, row_bytes, s, r in got["halo"]:
            assert r <= (top + bottom) * row_bytes and max(top, bottom) <= max(9, HALO), label
            sent, received = sent + s, received + r
        whole = [g for g in got["gathers"] if g[0] != "warp gather"]
        assert [g[0] for g in whole] == ["output"]
        # a level's warp gathers only where its shard (128 / 2^(level-1) / n rows) is below the halo
        n_small = sum(1 for lv in range(1, 7) if 128 // 2 ** (lv - 1) // n < HALO)
        warps_a_level = {lv: 3 if lv < 6 else 2 for lv in range(1, 7)}  # M (not at level 6), S, R
        assert len(got["gathers"]) - 1 == sum(warps_a_level[lv] for lv in range(7 - n_small, 7))
    assert sent == received > 0


def test_run_spatial_2_writes_the_one_device_files(tmp_path):
    from piv_liteflownet_tpu_torch import run

    indir = W.write_pairs(tmp_path / "in", 3)
    base = ["-m", "piv", "-p", "--cpu", "-i", indir, "--batch_size", "2"]
    run.main(base + ["-o", str(tmp_path / "one")])
    run.main(base + ["-o", str(tmp_path / "two"), "--spatial", "2"])
    flows = {d: sorted((tmp_path / d / "PIV-LiteFlowNet-en" / "in" / "flow").glob("*.flo")) for d in ("one", "two")}
    assert [p.name for p in flows["two"]] == [p.name for p in flows["one"]] and len(flows["one"]) == 3
    for a, b in zip(flows["two"], flows["one"]):
        np.testing.assert_allclose(read_flow(str(a)), read_flow(str(b)), atol=PORT_ATOL, err_msg=a.name)
    with pytest.raises(ValueError, match="mutually exclusive"):
        run.main(base + ["-o", str(tmp_path / "x"), "--spatial", "2", "--num_devices", "2"])
    assert not os.path.exists(tmp_path / "x")


@pytest.mark.parametrize("stride", [1, 2])
def test_backwarp_takes_a_slab(stride):
    """The wrapper admits an image taller than its output rows, which start at the image's row
    ``row0``: the rows of the whole grid's warp; a negative or fractional ``row0`` raises."""
    rng = np.random.default_rng(stride)
    img = torch.from_numpy(rng.random((2, 5, 40, 24), dtype=np.float32))
    flow = torch.from_numpy(rng.uniform(-6, 6, (2, 2, 40 // stride, 24 // stride)).astype(np.float32))
    whole = warp.backwarp(img, flow, stride)
    first = 6 // stride
    got = warp.backwarp(img, flow[:, :, first:first + 7].contiguous(), stride, 6)
    torch.testing.assert_close(got, whole[:, :, first:first + 7], rtol=0, atol=1e-6)
    for row0 in (-1, 2.5):
        with pytest.raises(ValueError, match="does not fit"):
            warp.backwarp(img, flow[:, :, :3].contiguous(), stride, row0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_backwarp_kernel_takes_a_slab(cuda, dtype, stride):
    """K4's both forms on slabs, as the halo warp (rows from 8 of an 80-row slab) and its
    fallback (rows from 64 of the whole 128-row map) give them, against the plain version:
    float32 within 1e-5, bf16 within one bf16 ulp of the rounded float32 plain warp plus 1e-5.
    A slab is forward only on the card."""
    g = torch.Generator(device=cuda).manual_seed(stride)
    for h_img, row0 in ((80, 8), (128, 64)):
        img = torch.randn(2, 33, h_img, 96, device=cuda, generator=g).to(dtype)
        flow = ((torch.rand(2, 2, 64 // stride, 96 // stride, device=cuda, generator=g) - 0.5) * 16).to(dtype)
        before = warp.launches + warp.bf16_launches
        got = warp.backwarp(img, flow, stride, row0)
        torch.cuda.synchronize()
        assert warp.launches + warp.bf16_launches == before + 1 and got.dtype == dtype
        want = warp.backwarp_plain(img.float(), flow.float(), stride, row0)
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-5
        else:
            ref = want.to(dtype).float()
            _, e = torch.frexp(ref.abs())
            assert bool(((got.float() - ref).abs() <= torch.ldexp(torch.ones_like(ref), e - 8) + 1e-5).all())
    with pytest.raises(NotImplementedError, match="forward only"):
        warp.backwarp(img.float().requires_grad_(), flow.float(), stride, row0)
