"""The rest of the port's inference, held to the JAX package: the ``Inference`` class,
``evaluate``, and ``run``'s brightness/contrast path and ingest routes.

JAX params (a seeded random init) are carried across with ``from_jax_params``
(and through a ``.npz`` for the CLIs); both packages run on the same frames on
the CPU. Flows within atol 2e-4, rtol 1e-3 at 64x96 (the parity tolerance of
tests/test_model_parity.py); AEEs within 1e-4. ``Inference``'s four entry
points and ``run -b/-c`` must write JAX's names; ``evaluate`` must print
JAX's per-pair records on two same-shape pairs and one odd-shape pair; the
port's ``run`` must write bit-equal ``.flo`` files through the PIL threads,
``--native_io`` and a ``.pivseq`` (with and without ``--native_io``). Whole
models run here, so torch uses one thread.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from piv_liteflownet_tpu_torch import piv_liteflownet
from piv_liteflownet_tpu_torch import evaluate as port_evaluate
from piv_liteflownet_tpu_torch import run as port_run
from piv_liteflownet_tpu_torch.inference import Inference
from piv_liteflownet_tpu_torch.models.convert import from_jax_params
from piv_liteflownet_tpu_torch.models.factory import PIV_V1
from piv_liteflownet_tpu_torch.utils.flow_io import read_flow, write_flow

ATOL, RTOL = 2e-4, 1e-3
AEE_ATOL = 1e-4
H, W = 64, 96
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; these tests use one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(before)


def _repo_module(name):
    """A top-level JAX script of the repository, imported by path."""
    spec = importlib.util.spec_from_file_location(f"repo_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(n, h=H, w=W, seed=0):
    """``n`` particle-like uint8 frames, each a shifted copy of the last plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.random((h + 8, w + 8))
    out = []
    for i in range(n):
        f = base[i % 4:i % 4 + h, (2 * i) % 8:(2 * i) % 8 + w] + 0.05 * rng.random((h, w))
        out.append(np.repeat((np.clip(f, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1))
    return out


def _write_pairs(root, n, h=H, w=W, seed=0, start=0):
    os.makedirs(root, exist_ok=True)
    fr = _frames(2 * n, h, w, seed)
    for i in range(n):
        Image.fromarray(fr[2 * i]).save(os.path.join(root, f"p{start + i:02d}_img1.png"))
        Image.fromarray(fr[2 * i + 1]).save(os.path.join(root, f"p{start + i:02d}_img2.png"))
    return str(root)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX model, the port's model from its params, a ``.npz`` of those params)."""
    from piv_liteflownet_tpu.models.factory import piv_liteflownet as jax_piv

    jmodel = jax_piv(version=1, seed=3)
    params = {k: np.asarray(v) for k, v in jmodel.params.items()}
    npz = str(tmp_path_factory.mktemp("weights") / "piv_v1.npz")
    np.savez(npz, **params)
    return jmodel, piv_liteflownet(from_jax_params(PIV_V1, params), version=1, device="cpu"), npz


def _rel(paths, root):
    return [os.path.relpath(p, root) for p in paths]


def _assert_flows_close(got_paths, want_paths):
    assert len(got_paths) == len(want_paths) > 0
    for g, w in zip(got_paths, want_paths):
        np.testing.assert_allclose(read_flow(g), read_flow(w), atol=ATOL, rtol=RTOL, err_msg=g)


def test_inference_class_matches_jax(models, tmp_path):
    import cv2

    from piv_liteflownet_tpu.inference import Inference as JInference

    jmodel, model, _ = models
    pairs = _write_pairs(tmp_path / "pairs", 2)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, f in enumerate(_frames(3, seed=1)):
        Image.fromarray(f).save(frames / f"f{i:02d}.png")
    video = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 5, (W, H))
    for f in _frames(3, seed=2):
        writer.write(f[..., ::-1].copy())
    writer.release()

    port = Inference(model, netname="w/piv_v1.npz", output_dir=str(tmp_path / "port"))
    jax = JInference(jmodel, netname="w/piv_v1.npz", output_dir=str(tmp_path / "jax"))
    assert port.default == str(tmp_path / "port" / "piv_v1")
    for call, args in (("images_parsing", (pairs, True)), ("images_parsing", (str(frames), False)),
                       ("dataloader_parsing", (pairs, True)), ("video_parsing", (video,))):
        got, want = getattr(port, call)(*args), getattr(jax, call)(*args)
        assert _rel(got, tmp_path / "port") == _rel(want, tmp_path / "jax"), call
        _assert_flows_close(got, want)
    assert _rel(port.video_parsing(video), tmp_path / "port") == [
        "piv_v1/vid_clip/clip_000001_out.flo", "piv_v1/vid_clip/clip_000002_out.flo"]

    im1, im2 = (Image.open(os.path.join(pairs, f"p00_img{k}.png")) for k in (1, 2))
    flow8 = Inference.parser(model, im1, im2)  # 8-bit frames: divided by 255
    a1, a2 = (np.asarray(im, np.float32) / 255.0 for im in (im1, im2))
    np.testing.assert_array_equal(Inference.parser(model, a1, a2), flow8)
    np.testing.assert_allclose(flow8, np.asarray(JInference.parser(jmodel, im1, im2)), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="NOT found"):
        port.images_parsing(str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="same shape"):
        Inference.parser(model, a1, a1[:32])


def test_evaluate_matches_jax(models, tmp_path, capsys):
    _, _, npz = models
    indir = _write_pairs(tmp_path / "ev", 2)
    _write_pairs(indir, 1, h=48, w=80, seed=5, start=2)  # an odd shape: its own batch, the /32 resize
    rng = np.random.default_rng(9)
    for i, shape in enumerate([(H, W), (H, W), (48, 80)]):
        write_flow(rng.standard_normal((*shape, 2)).astype(np.float32), os.path.join(indir, f"p{i:02d}_flow.flo"))
    argv = ["-i", indir, "--model", "piv", "--cpu", "--params", npz]
    port_agg = port_evaluate.main(argv + ["--save", str(tmp_path / "pred"), "--viz"])
    port_lines = capsys.readouterr().out.strip().splitlines()
    jax_agg = _repo_module("evaluate").main(argv)
    jax_lines = capsys.readouterr().out.strip().splitlines()
    assert len(port_lines) == len(jax_lines) == 4
    assert json.loads(port_lines[-1]) == {"aggregate": port_agg}
    for got, want in zip(map(json.loads, port_lines[:3]), map(json.loads, jax_lines[:3])):
        assert got["pair"] == want["pair"]
        assert abs(got["epe_mean"] - want["epe_mean"]) <= AEE_ATOL
        assert abs(got["epe_max"] - want["epe_max"]) <= 10 * AEE_ATOL
    assert port_agg["pairs"] == jax_agg["pairs"] == 3
    assert abs(port_agg["aee"] - jax_agg["aee"]) <= AEE_ATOL
    saved = sorted(os.listdir(tmp_path / "pred"))
    assert saved == ["p00_out.flo", "p00_out.png", "p01_out.flo", "p01_out.png", "p02_out.flo", "p02_out.png"]
    assert read_flow(str(tmp_path / "pred" / "p02_out.flo")).shape == (48, 80, 2)
    batched = port_evaluate.main(argv + ["-b", "1"])  # one pair a forward: the same records
    assert abs(batched["aee"] - port_agg["aee"]) <= 1e-6


def test_run_brightness_contrast_writes_jax_names(models, tmp_path):
    _, _, npz = models
    indir = _write_pairs(tmp_path / "in", 2)
    argv = ["-m", "piv", "-i", indir, "--cpu", "--params", npz, "-b", "0.8", "1.2", "-c", "1.0"]
    got = port_run.main(argv + ["-o", str(tmp_path / "port")])[0]
    _repo_module("run").main(argv + ["-o", str(tmp_path / "jax")])
    flodir = ("piv_v1", "in", "flow")
    names = sorted(os.listdir(tmp_path.joinpath("port", *flodir)))
    assert names == sorted(os.listdir(tmp_path.joinpath("jax", *flodir)))
    assert len(got) == len(names) == 2 * 3  # 3 consecutive frame pairs, 2 brightness factors
    assert "p00_img1_080_100_img1_out.flo" not in names and "p00_080_100_img1_out.flo" in names
    _assert_flows_close([str(tmp_path.joinpath("port", *flodir, n)) for n in names],
                        [str(tmp_path.joinpath("jax", *flodir, n)) for n in names])

    port_run.main(["-m", "piv", "-i", indir, "--cpu", "--params", npz, "-b", "1.0", "-c", "1.0",
                   "-o", str(tmp_path / "one")])
    port_run.main(["-m", "piv", "-p", "-i", indir, "--cpu", "--params", npz, "--batch_size", "1",
                   "-o", str(tmp_path / "plain")])
    for k in range(2):  # the factor 1.0 leaves the frames as they are
        np.testing.assert_array_equal(read_flow(str(tmp_path.joinpath("one", *flodir, f"p{k:02d}_100_100_img1_out.flo"))),
                                      read_flow(str(tmp_path.joinpath("plain", *flodir, f"p{k:02d}_img1_out.flo"))))


def test_run_ingest_routes_write_bit_equal_flows(tmp_path, capsys):
    from piv_liteflownet_tpu_torch.data.pivseq import pack_directory

    indir = _write_pairs(tmp_path / "in", 3, h=32, w=32, seed=4)
    seq = pack_directory(indir, str(tmp_path / "in.pivseq"))
    base = ["-m", "piv", "-p", "--cpu", "--batch_size", "2"]
    routes = {"pil": ["-i", indir], "native": ["-i", indir, "--native_io"], "seq": ["-i", seq],
              "seq native": ["-i", seq, "--native_io"]}
    stats, blobs = {}, {}
    for name, extra in routes.items():
        out = tmp_path / name.replace(" ", "_")
        stats[name] = port_run.main(base + extra + ["-o", str(out)])[0]
        flodir = out / "PIV-LiteFlowNet-en" / os.path.basename(extra[1]) / "flow"
        blobs[name] = {f: (flodir / f).read_bytes() for f in sorted(os.listdir(flodir))}
    printed = capsys.readouterr().out
    assert "native I/O: libpivio's C loader (NativeBatchLoader)" in printed
    assert "native I/O: libpivio's C loader (NativeSeqLoader)" in printed
    assert list(blobs["pil"]) == ["p00_img1_out.flo", "p01_img1_out.flo", "p02_img1_out.flo"]
    for name in routes:
        assert blobs[name] == blobs["pil"], name
        assert stats[name].pairs == 3
    assert [stats[k].loader for k in routes] == ["python", "native", "python", "native"]

    jpg = tmp_path / "jpg"  # a format the C decoders reject: the Python loader, with a line saying so
    jpg.mkdir()
    for f in ("p00_img1", "p00_img2"):
        Image.open(os.path.join(indir, f + ".png")).save(jpg / (f + ".jpg"))
    assert port_run.main(base + ["-i", str(jpg), "--native_io", "-o", str(tmp_path / "o")])[0].loader == "python"
    assert "native I/O: not for this dataset's formats" in capsys.readouterr().out


@pytest.mark.parametrize("fault", ["truncated", "odd size"])
@pytest.mark.parametrize("native_io", [False, True])
def test_run_raises_on_a_bad_frame_through_either_loader(tmp_path, fault, native_io):
    """A frame that does not decode, or a pair of another size than the first, stops ``run``
    with an error through the PIL threads and through libpivio alike: nothing is cropped,
    padded or written as zeros in its place."""
    indir = _write_pairs(tmp_path / "in", 3, h=32, w=32, seed=5)
    bad = os.path.join(indir, "p01_img2.png" if fault == "truncated" else "p01_img1.png")
    if fault == "truncated":
        blob = open(bad, "rb").read()
        open(bad, "wb").write(blob[:len(blob) // 2])
    else:
        for f in ("p01_img1.png", "p01_img2.png"):
            Image.fromarray(_frames(1, h=32, w=48, seed=9)[0]).save(os.path.join(indir, f))
    argv = ["-m", "piv", "-p", "--cpu", "--batch_size", "2", "-i", indir, "-o", str(tmp_path / "out")]
    with pytest.raises((OSError, ValueError)) as err:
        port_run.main(argv + (["--native_io"] if native_io else []))
    if native_io or fault == "odd size":
        assert "p01_img" in str(err.value)


@pytest.mark.parametrize("flag", ["--num_devices", "--spatial"])
def test_run_multi_gpu_flags_raise(tmp_path, flag):
    """Both flags are ported (tests/test_torch_parallel.py, tests/test_torch_spatial.py); together
    they raise, as JAX's run.py asserts."""
    other = "--spatial" if flag == "--num_devices" else "--num_devices"
    with pytest.raises(ValueError, match="mutually exclusive"):
        port_run.main(["-m", "piv", "-i", str(tmp_path), "--cpu", flag, "2", other, "2"])


def test_run_conv_impl_chain_writes_the_cudnn_flows(tmp_path):
    indir = _write_pairs(tmp_path / "in", 1, h=32, w=32, seed=6)
    flows = {}
    for impl in ("cudnn", "chain"):
        port_run.main(["-m", "piv", "-p", "--cpu", "-i", indir, "--conv_impl", impl, "-o", str(tmp_path / impl)])
        flows[impl] = read_flow(str(tmp_path / impl / "PIV-LiteFlowNet-en" / "in" / "flow" / "p00_img1_out.flo"))
    np.testing.assert_allclose(flows["chain"], flows["cudnn"], atol=ATOL, rtol=RTOL)


def test_estimate_keeps_its_constants_on_the_device():
    """The model's rgb mean and estimate's u/v scale are made once per (values, dtype, device):
    a tensor built from host values anew each call would be a blocking copy on the card."""
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.ops.nn import device_constant

    c = device_constant((0.5, 0.25), torch.bfloat16, torch.device("cpu"))
    assert c is device_constant((0.5, 0.25), torch.bfloat16, torch.device("cpu"))
    assert torch.equal(c, torch.tensor([0.5, 0.25], dtype=torch.bfloat16))
    model = piv_liteflownet(version=1, device="cpu")
    im = np.random.default_rng(0).random((40, 48, 3), dtype=np.float32)
    estimate(model, im, im)
    before = device_constant.cache_info()
    estimate(model, im, im)
    after = device_constant.cache_info()
    assert after.misses == before.misses and after.hits == before.hits + 2
