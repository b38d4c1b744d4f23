"""The PyTorch port's ``.flo`` I/O, CLI output layout and import rule.

The ``.flo`` bytes are held to the JAX package's writer, the CLI to the
output-layout contract of tests/test_cli.py. The port and ``chip_smoke.py``
must not import JAX or the JAX package: the machine with the card has
neither.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest

from piv_liteflownet_tpu_torch import run as port_run
from piv_liteflownet_tpu_torch.utils.flow_io import (
    flowname_modifier, read_flow, write_flow)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("bands", [2, 3])
def test_flo_bytes_match_jax_writer(tmp_path, bands):
    from piv_liteflownet_tpu.utils import flow_io as jio

    flow = np.random.default_rng(bands).standard_normal((7, 11, bands)).astype(np.float32)
    ours, theirs = str(tmp_path / "a.flo"), str(tmp_path / "b.flo")
    write_flow(flow, ours)
    jio.write_flow(flow, theirs)
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    np.testing.assert_array_equal(read_flow(theirs, use_stereo=bands == 3), flow)
    np.testing.assert_array_equal(jio.read_flow(ours, use_stereo=bands == 3), flow)


def test_flo_reader_rejects_bad_files(tmp_path):
    bad = tmp_path / "bad.flo"
    bad.write_bytes(np.array([1.0, 2.0, 3.0], np.float32).tobytes())
    with pytest.raises(ValueError, match="Tag"):
        read_flow(str(bad))
    with pytest.raises(FileNotFoundError):
        read_flow(str(tmp_path / "missing.flo"))
    with pytest.raises(ValueError):
        write_flow(np.zeros((4, 4, 2), np.float32), str(tmp_path / "x.png"))


@pytest.mark.parametrize("name,pair", [("/a/b/p00_img1.png", True), ("/a/b/p00_img1.png", False),
                                       ("frame_000123.tif", False), ("x_y_img1.bmp", True)])
def test_flowname_modifier_matches_jax(name, pair):
    from piv_liteflownet_tpu.utils.flow_io import flowname_modifier as jmod

    assert flowname_modifier(name, "/out", pair=pair) == jmod(name, "/out", pair=pair)


def _make_pairs(root, n=2, size=(32, 32), seed=0):
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        for tag in ("img1", "img2"):
            Image.fromarray((rng.random((*size, 3)) * 255).astype(np.uint8)).save(
                os.path.join(root, f"p{i:02d}_{tag}.png"))


@pytest.mark.parametrize("is_pair,start,n", [(True, 0, -1), (True, 1, 2), (False, 0, -1), (False, 1, 3)])
def test_image_pairs_match_jax_run_dataset(tmp_path, is_pair, start, n):
    """The directory scan of the port's ``run``: ``Run.pairs``, with a non-image file beside the frames."""
    from piv_liteflownet_tpu.data.datasets import Run as JaxRun
    from piv_liteflownet_tpu_torch.data.datasets import Run

    _make_pairs(str(tmp_path), n=3, size=(8, 8))
    (tmp_path / "notes.txt").write_text("not an image")
    want = JaxRun(str(tmp_path), is_pair=is_pair, n_images=n, start_at=start).pairs
    assert Run(str(tmp_path), is_pair, n, start).pairs == want


def test_run_cli_pair_mode_layout(tmp_path):
    indir, outdir = str(tmp_path / "in"), str(tmp_path / "out")
    _make_pairs(indir, n=3)
    port_run.main(["--model", "piv", "--version", "1", "-p", "-i", indir, "-o", outdir,
                   "--cpu", "--batch_size", "2"])
    flodir = os.path.join(outdir, "PIV-LiteFlowNet-en", "in", "flow")
    flos = sorted(os.listdir(flodir))
    assert flos == ["p00_img1_out.flo", "p01_img1_out.flo", "p02_img1_out.flo"]
    flow = read_flow(os.path.join(flodir, flos[0]))
    assert flow.shape == (32, 32, 2) and np.isfinite(flow).all()
    assert os.path.isfile(os.path.join(outdir, "PIV-LiteFlowNet-en", "in", "args.txt"))


def test_run_cli_start_slice_naming_and_npz_params(tmp_path):
    from piv_liteflownet_tpu_torch.models.factory import PIV_V1
    from piv_liteflownet_tpu_torch.models.liteflownet import LiteFlowNet

    indir, outdir = str(tmp_path / "in2"), str(tmp_path / "out2")
    _make_pairs(indir, n=3)
    npz = str(tmp_path / "weights.npz")
    np.savez(npz, **{k: np.zeros(1, np.float32) for k in LiteFlowNet(PIV_V1).state_dict()})
    with pytest.raises(ValueError, match="shape"):  # .npz holds JAX params: checked on load
        port_run.main(["--model", "piv", "-p", "-i", indir, "-o", outdir, "--cpu", "--params", npz])
    port_run.main(["--model", "piv", "-p", "-s", "1", "-n", "2", "-i", indir, "-o", outdir, "--cpu"])
    sub = os.path.join(outdir, "PIV-LiteFlowNet-en", "in2-1_2", "flow")
    assert sorted(os.listdir(sub)) == ["p01_img1_out.flo", "p02_img1_out.flo"]


def test_breakdown_groups_and_idle_share():
    from piv_liteflownet_tpu_torch.breakdown import busy_and_span, group_of, summarize

    assert group_of("void (anonymous namespace)::corr49_kernel(float const*)") == "corr49"
    for form in ("f32", "bf16"):  # the chain's two kernels, not the cuDNN convs
        assert group_of(f"(anonymous namespace)::conv_chain_{form}_kernel(...)") == "conv_chain"
    assert group_of("sm90_xmma_fprop_implicit_gemm_f32f32") == "conv"
    assert group_of("void at::native::vectorized_elementwise_kernel<4>") == "elementwise/reduce"
    assert group_of("Memcpy HtoD (Pageable -> Device)") == "memcpy/memset"
    assert busy_and_span([(0, 10), (5, 12), (20, 30), (21, 22)]) == (22, 30)
    out = summarize([("backwarp_kernel", 0, 1000), ("cudnn_conv", 3000, 7000)], calls=2)
    assert out["device_ms_per_call"] == {"conv": 2.0, "backwarp": 0.5}
    assert out["busy_ms_per_call"] == 2.5 and out["span_ms_per_call"] == 3.5
    assert abs(out["idle_share"] - 2 / 7) < 1e-12


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_and_chip_smoke_never_import_jax():
    files = sorted((REPO / "piv_liteflownet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "piv_liteflownet_tpu")]
    assert bad == []
