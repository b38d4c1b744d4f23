"""The port's data slice against the JAX package: the particle-image generator, the flow
fields, ``make_dataset_dir``, the datasets, the loaders, the rest of ``flow_io``, ``.npz``
params and ``.paramOnly`` files.

Torch's random stream is not JAX's, so the generator is held to JAX's given
JAX's sampled particles: render, advection and pair within atol 1e-5 (the
render is a float32 product over ~45 particles a pixel, in another summation
order). The flow fields within 1e-6 (float32 sin/cos/sqrt of two libraries).
Datasets, manifests, file lists and the loaders' batch order must be equal.
Sizes are small (32x40 frames, a few pairs).
"""

import json
import os

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch.data import datasets as D
from piv_liteflownet_tpu_torch.data import piv_gen as G
from piv_liteflownet_tpu_torch.data.loader import (BatchLoader, PrefetchLoader, _collate,
                                                   native_loader_for, native_train_loader_for)
from piv_liteflownet_tpu_torch.models import factory
from piv_liteflownet_tpu_torch.models.convert import from_jax_params, load_param_only, to_jax_params
from piv_liteflownet_tpu_torch.utils import flow_io as fio
from piv_liteflownet_tpu_torch.utils.checkpoint import load_params_npz, save_params_npz

SIZE = (32, 40)


def _jax_gen(size=SIZE):
    from piv_liteflownet_tpu.data.piv_gen import ParticleImageGen

    return ParticleImageGen(image_size=size)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# -- the generator ---------------------------------------------------------------------------

def test_render_interp_and_pair_match_jax_given_its_particles():
    import jax

    jgen, gen = _jax_gen(), G.ParticleImageGen(image_size=SIZE)
    assert gen.n_particles == jgen.n_particles
    key = jax.random.PRNGKey(3)
    parts = jgen.sample_particles(jax.random.split(key, 2)[0])
    np.testing.assert_allclose(gen.render(*map(_t, parts)).numpy(), np.asarray(jgen.render(*parts)),
                               atol=1e-5, rtol=0)
    flow = np.asarray(G.vortex_flow(*SIZE, device="cpu").numpy() * 1.7)
    np.testing.assert_allclose(gen._interp_flow(_t(flow), _t(parts[0]), _t(parts[1])).numpy(),
                               np.asarray(jgen._interp_flow(flow, parts[0], parts[1])), atol=1e-5, rtol=0)
    # generate_pair samples from its key; the port's advect of those particles equals it
    want = jgen.generate_pair(key, flow)
    got = gen.advect(tuple(map(_t, jgen.sample_particles(key))), _t(flow))
    for g, w in zip(got, want):
        assert g.shape == (*SIZE, 3) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_particles_follow_the_generator_and_their_ranges():
    gen = G.ParticleImageGen(image_size=SIZE, d_std=2.0)
    x, y, z, d = gen.sample_particles(torch.Generator().manual_seed(5), "cpu")
    again = gen.sample_particles(torch.Generator().manual_seed(5), "cpu")
    assert all(torch.equal(a, b) for a, b in zip((x, y, z, d), again))
    assert x.shape == (gen.n_particles,) and x.min() >= -8 and x.max() <= SIZE[1] + 8
    assert y.max() <= SIZE[0] + 8 and z.abs().max() <= 1 and d.min() >= 1.0
    im1, im2 = gen.generate_batch(torch.Generator().manual_seed(1), torch.zeros(2, *SIZE, 2), "cpu")
    assert im1.shape == (2, *SIZE, 3) and torch.equal(im1, im2)  # zero flow: the same frame
    assert 0 <= im1.min() and im1.max() <= 1 and not torch.equal(im1[0], im1[1])


def test_the_generator_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = G.ParticleImageGen(image_size=SIZE)
    for call in (lambda: gen.sample_particles(torch.Generator()),
                 lambda: gen.generate_pair(torch.Generator(), torch.zeros(*SIZE, 2)),
                 lambda: gen.generate_batch(torch.Generator(), torch.zeros(1, *SIZE, 2)),
                 lambda: G.FLOW_FIELDS["sine"](*SIZE),
                 lambda: G.make_dataset_dir(str(tmp_path / "ds"), n=1, size=SIZE)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "ds").exists()


@pytest.mark.parametrize("name", ["uniform", "vortex", "shear", "sine"])
@pytest.mark.parametrize("size", [(32, 40), (37, 53)])
def test_flow_fields_match_jax(name, size):
    from piv_liteflownet_tpu.data.piv_gen import FLOW_FIELDS as JF

    got = G.FLOW_FIELDS[name](*size, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (*size, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(JF[name](*size)), atol=1e-6, rtol=0)


def test_make_dataset_dir_matches_jax_layout(tmp_path):
    from piv_liteflownet_tpu.data.piv_gen import make_dataset_dir as jmake

    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    G.make_dataset_dir(str(ours), n=6, size=SIZE, seed=2, device="cpu")
    jmake(str(theirs), n=6, size=SIZE, seed=2)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for manifest in ("train.json", "val.json"):
        assert json.loads((ours / manifest).read_text()) == json.loads((theirs / manifest).read_text())
    for i in range(6):
        flo = f"sample_{i:04d}_flow.flo"
        np.testing.assert_allclose(fio.read_flow(str(ours / flo)), fio.read_flow(str(theirs / flo)),
                                   atol=1e-6, rtol=0)
        (im1, im2), flow = D.PIVData(str(ours), "train" if i < 4 else "val")[i % 4]
        assert im1.shape == (*SIZE, 3) and np.array_equal(im1[..., 0], im1[..., 2])
    # the seed fixes the particles
    G.make_dataset_dir(str(tmp_path / "again"), n=2, size=SIZE, seed=2, write_manifest=False, device="cpu")
    assert (tmp_path / "again" / "sample_0001_img2.png").read_bytes() == (ours / "sample_0001_img2.png").read_bytes()
    assert not (tmp_path / "again" / "train.json").exists()


# -- the datasets ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One directory of synthetic triplets, one of plain sequential frames, stereo subdirs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("data")
    G.make_dataset_dir(str(root / "pairs"), n=6, size=SIZE, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    for sub in ("seq", "stereo/left", "stereo/right"):
        os.makedirs(root / sub)
        for i in range(5):
            Image.fromarray(rng.integers(0, 255, (*SIZE, 3), dtype=np.uint8)).save(
                root / sub / f"frame_{i:03d}.png")
    return root


def _same_sample(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_sample(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("is_pair,n,start", [(True, -1, 0), (True, 2, 1), (False, -1, 0), (False, 3, 2)])
def test_run_matches_jax(tree, is_pair, n, start):
    from piv_liteflownet_tpu.data.datasets import Run as JRun

    root = str(tree / ("pairs" if is_pair else "seq"))
    ours, theirs = D.Run(root, is_pair, n, start), JRun(root, is_pair, n, start)
    assert ours.pairs == theirs.pairs and len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        _same_sample(ours[i], theirs[i])


@pytest.mark.parametrize("sub,pair,stereo", [("pairs", True, False), ("seq", False, False),
                                             ("stereo", False, True)])
def test_inference_run_matches_jax(tree, sub, pair, stereo):
    from piv_liteflownet_tpu.data.datasets import InferenceRun as JIR

    ours = D.InferenceRun(str(tree / sub), pair, stereo, crop_multiple=16)
    theirs = JIR(str(tree / sub), pair, stereo, crop_multiple=16)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        _same_sample(ours[i], theirs[i])
    assert ours[0][0][0].shape == (32, 32, 3)


def test_inference_eval_and_pivdata_match_jax(tree):
    from piv_liteflownet_tpu.data.datasets import InferenceEval as JIE, PIVData as JPD

    root = str(tree / "pairs")
    ours, theirs = D.InferenceEval(root), JIE(root)
    assert ours.flows == theirs.flows and len(ours) == 6
    for i in range(len(ours)):
        _same_sample(ours[i], theirs[i])
    for mode in ("train", "val"):
        ours, theirs = D.PIVData(root, mode, crop_multiple=16), JPD(root, mode, crop_multiple=16)
        assert ours.samples == theirs.samples and ours.render_size == theirs.render_size == (32, 32)
        for i in range(len(ours)):
            _same_sample(ours[i], theirs[i])
    with pytest.raises(FileNotFoundError):
        D.PIVData(root, "test")


def test_pivh5_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    from piv_liteflownet_tpu.data.datasets import PIVH5 as JH5

    rng = np.random.default_rng(4)
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("train")
        g["data1"] = rng.integers(0, 255, (3, *SIZE)).astype(np.uint8)  # grey, 0-255
        g["data2"] = rng.integers(0, 255, (3, *SIZE)).astype(np.uint8)
        g["label"] = rng.standard_normal((3, *SIZE, 2)).astype(np.float32)
    ours, theirs = D.PIVH5(path, "train", crop_multiple=16), JH5(path, "train", crop_multiple=16)
    assert len(ours) == len(theirs) == 3 and ours.render_size == theirs.render_size
    for i in range(3):
        _same_sample(ours[i], theirs[i])
    ours.close()
    theirs.close()


def test_pivlmdb_needs_lmdb(tmp_path):
    try:
        import lmdb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="lmdb"):
            D.PIVLMDB(str(tmp_path))


# -- the loaders -------------------------------------------------------------------------------

class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((2, 2, 3), i, np.float32), np.zeros((2, 2, 3), np.float32)), np.full((2, 2, 2), i, np.float32)


@pytest.mark.parametrize("shuffle,drop_last,workers", [(True, True, 0), (True, False, 3), (False, False, 2)])
def test_batch_loader_order_matches_jax(shuffle, drop_last, workers):
    from piv_liteflownet_tpu.data.loader import BatchLoader as JBL

    ds = _Indices(11)
    ours = BatchLoader(ds, 3, workers, shuffle=shuffle, seed=7, drop_last=drop_last)
    theirs = JBL(ds, 3, workers, shuffle=shuffle, seed=7, drop_last=drop_last)
    assert len(ours) == len(theirs)
    for epoch in (1, 2, 5, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a = [t[..., 0, 0, 0].tolist() for _, t in ours]
        b = [t[..., 0, 0, 0].tolist() for _, t in theirs]
        assert a == b and len(a) == len(ours)


def test_collate_matches_jax():
    from piv_liteflownet_tpu.data.loader import _collate as jcollate

    ds = _Indices(3)
    named = [((ds[i][0][0], ds[i][0][1]), f"n{i}") for i in range(3)]
    for samples in ([ds[i] for i in range(3)], named):
        _same_sample(_collate(samples), jcollate(samples))


def test_prefetch_loader_on_the_cpu_yields_the_batches_unchanged():
    batches = [_collate([_Indices(5)[i] for i in (j, j + 1)]) for j in range(3)]
    batches.append(((np.ones((1, 2, 2, 3), np.float32), np.zeros((1, 2, 2, 3), np.float32)), ["a name"]))
    got = list(PrefetchLoader(batches, "cpu", prefetch=1))
    assert len(got) == len(batches)
    for ((g1, g2), gm), ((b1, b2), bm) in zip(got, batches):
        assert isinstance(g1, torch.Tensor) and g1.device.type == "cpu"
        np.testing.assert_array_equal(g1.numpy(), b1)
        np.testing.assert_array_equal(g2.numpy(), b2)
        if isinstance(bm, np.ndarray):
            np.testing.assert_array_equal(gm.numpy(), bm)
            assert not np.shares_memory(gm.numpy(), bm)
        else:
            assert gm == bm


def test_prefetch_loader_raises_the_producers_error_and_stops_early():
    def broken():
        yield (np.zeros(2, np.float32), np.zeros(2, np.float32)), np.zeros(1, np.float32)
        raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(PrefetchLoader(broken(), "cpu"))
    it = iter(PrefetchLoader(([np.zeros(1, np.float32)] for _ in range(100)), "cpu", prefetch=1))
    next(it)
    it.close()  # the producer thread stops and is joined


def test_native_loaders_are_not_ported():
    """The native loaders are ported (tests/test_torch_native_io.py); a dataset with no frame
    pairs or triplets takes neither."""
    for fn in (native_loader_for, native_train_loader_for):
        assert fn(None, 2) is None


# -- flow_io -----------------------------------------------------------------------------------

def test_flow_io_helpers_match_jax(tmp_path):
    from piv_liteflownet_tpu.utils import flow_io as jio

    rng = np.random.default_rng(8)
    flow = (3 * rng.standard_normal((12, 17, 2))).astype(np.float32)
    for i in (3, 10, 1):
        fio.write_flow(flow + i, str(tmp_path / f"f_{i:02d}.flo"))
    path = str(tmp_path / "f_03.flo")
    for crop in (0, 2, (1, 0, 3, 2)):
        np.testing.assert_array_equal(fio.read_flow(path, crop_window=crop), jio.read_flow(path, crop_window=crop))
    fio.write_flow(flow, str(tmp_path / "a.flo"), norm=True)
    jio.write_flow(flow, str(tmp_path / "b.flo"), norm=True)
    assert (tmp_path / "a.flo").read_bytes() == (tmp_path / "b.flo").read_bytes()
    (tmp_path / "a.flo").unlink(), (tmp_path / "b.flo").unlink()
    ours, theirs = fio.read_flow_collection(str(tmp_path), 1, 2, crop_window=1), \
        jio.read_flow_collection(str(tmp_path), 1, 2, crop_window=1)
    assert ours[1] == theirs[1] and ours[1][0].endswith("f_03.flo")
    np.testing.assert_array_equal(ours[0], theirs[0])
    u = flow[..., 0].copy()
    u[0, 0], u[1, 1] = np.nan, 2e9
    np.testing.assert_array_equal(fio.unknown_flow(u, flow[..., 1]), jio.unknown_flow(u, flow[..., 1]))
    for flip in ("horizontal_flip_flow", "vertical_flip_flow"):
        np.testing.assert_array_equal(getattr(fio, flip)(flow), getattr(jio, flip)(flow))
    for name in ("x_img1.png", "x_img2.png", "y_img1.tif", "z.jpg"):
        (tmp_path / name).write_bytes(b"")
    for pair in (True, False):
        assert fio.image_files_from_folder(str(tmp_path), pair) == jio.image_files_from_folder(str(tmp_path), pair)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("size", [(80, 60), (20, 15), (17, 12)])
def test_resize_flow_matches_jax(method, size):
    pytest.importorskip("cv2")  # the JAX package resizes with OpenCV
    from piv_liteflownet_tpu.utils.flow_io import resize_flow as jresize

    flow = (3 * np.random.default_rng(1).standard_normal((12, 17, 2))).astype(np.float32)
    # OpenCV rounds its bilinear coefficients: within 1e-4 of the exact weights' result
    np.testing.assert_allclose(fio.resize_flow(flow, *size, method), jresize(flow.copy(), *size, method),
                               atol=1e-4, rtol=0)
    assert fio.resize_flow(flow, 17, 12) is flow
    with pytest.raises(ValueError):
        fio.resize_flow(flow, 20, 15, "cubic")


# -- weights -----------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_v1():
    from piv_liteflownet_tpu.models.factory import piv_liteflownet as jpiv

    jm = jpiv(version=1, seed=4)
    return jm.cfg, {k: np.asarray(v) for k, v in jm.params.items()}


def _equal_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_params_npz_round_trip_with_jax(tmp_path, jax_v1):
    from piv_liteflownet_tpu.utils.checkpoint import load_params_npz as jload, save_params_npz as jsave

    _, params = jax_v1
    cfg = factory.PIV_V1
    jsave(params, str(tmp_path / "j.npz"))
    _equal_state(load_params_npz(cfg, str(tmp_path / "j.npz")), from_jax_params(cfg, params))
    save_params_npz(cfg, from_jax_params(cfg, params), str(tmp_path / "p.npz"))
    back = jload(str(tmp_path / "p.npz"))
    assert back.keys() == params.keys()
    for k in params:
        np.testing.assert_array_equal(np.asarray(back[k]), params[k])
    assert to_jax_params(cfg, from_jax_params(cfg, params)).keys() == params.keys()


def test_load_param_only_matches_from_jax_params(tmp_path, jax_v1):
    from piv_liteflownet_tpu.models.convert import to_torch_state_dict

    jcfg, params = jax_v1
    cfg = factory.PIV_V1
    state = {k: torch.from_numpy(v.copy()) for k, v in to_torch_state_dict(jcfg, params).items()}
    torch.save(state, str(tmp_path / "w.paramOnly"))
    _equal_state(load_param_only(cfg, str(tmp_path / "w.paramOnly")), from_jax_params(cfg, params))
    bad = dict(state)
    bad.pop("NetC.conv1.0.weight")
    torch.save(bad, str(tmp_path / "missing.paramOnly"))
    with pytest.raises(KeyError, match="missing"):
        load_param_only(cfg, str(tmp_path / "missing.paramOnly"))
    bad["NetC.conv1.0.weight"] = state["NetC.conv1.0.weight"][:, :2]
    torch.save(bad, str(tmp_path / "shape.paramOnly"))
    with pytest.raises(ValueError, match="shape"):
        load_param_only(cfg, str(tmp_path / "shape.paramOnly"))


def test_model_config_registry_matches_jax():
    from piv_liteflownet_tpu.models.factory import model_config_registry as jreg

    ours, theirs = factory.model_config_registry(), jreg()
    assert list(ours) == list(theirs)
    for name in ours:
        a, b = ours[name](), theirs[name]()
        assert (a.version, a.starting_scale, a.lowest_level, a.rgb_mean) == \
            (b.version, b.starting_scale, b.lowest_level, b.rgb_mean)
    assert ours["LiteFlowNet"]() == factory.PIV_V1 and ours["LiteFlowNet2"]() == factory.PIV_V2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_generator_on_the_card_matches_the_cpu(cuda):
    gen = G.ParticleImageGen(image_size=(96, 128))
    flow = G.FLOW_FIELDS["vortex"](96, 128, device="cpu")
    want = gen.generate_pair(torch.Generator().manual_seed(2), flow, device="cpu")
    got = gen.generate_pair(torch.Generator().manual_seed(2), flow)  # None: the card
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=0)
