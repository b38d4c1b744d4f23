"""Stereo PIV of the port held to the JAX package: the stereo modules, ``stereo_cal`` and
``stereo_run``.

The numpy/scipy pieces the port copies (``gen_template``, ``grid_regularize``,
``map_coeff``, ``select_ref_points``) must give JAX's values; the ones it runs
in torch (``willert``, ``nl_trans``, ``warp_image``) JAX's float64 values to
1e-12, the remap exactly. ``template_matching`` is the port's own normalised
cross-correlation: against JAX's (OpenCV's ``matchTemplate`` + ``blur``) on a
clean and a noisy synthetic plate, the map within 1e-4, the same number of
cross centres, each within 1e-3 px, and flat windows 0. ``stereo_cal --clicks``:
its crosses within 1e-3 px of OpenCV's, and given those crosses the fitted mappings of the
grid points within 0.01 px of JAX's.
``stereo_run``: ``flo_process`` within one float32 ulp of JAX's, and a
``direct`` run on a 64x64 stereo pair with the same weights (a JAX init
carried through a ``.npz``) within the parity tolerance (atol 2e-4, rtol
1e-3, tests/test_model_parity.py's), the port's ``manual`` run within 1e-4
px of its ``direct`` one. Whole models run here, so torch uses one thread.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from piv_liteflownet_tpu_torch import stereo_cal as port_cal
from piv_liteflownet_tpu_torch import stereo_run as port_run
from piv_liteflownet_tpu_torch.stereo import dewarp, matching, vel3d
from piv_liteflownet_tpu_torch.utils.flow_io import read_flow, write_flow
from piv_liteflownet_tpu_torch.utils.synthetic import calibration_plate, particle_pair

REPO = Path(__file__).resolve().parents[1]
ATOL, RTOL = 2e-4, 1e-3
#: a mild rational distortion of a camera's view (coefficients of ``nl_trans``)
DISTORT = np.zeros(24)
DISTORT[[0, 1, 3, 6, 8]] = [1.0, 0.02, 2e-5, 1e-5, 1.0]
DISTORT[[12, 13, 16, 19, 20]] = [-0.015, 1.0, 1e-5, -1e-5, 1.0]


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


def _identity(scale=1.0):
    A = np.zeros(24)
    A[0], A[8], A[13], A[20] = scale, 1.0, scale, 1.0
    return A


# -- the modules ---------------------------------------------------------------------------

def test_willert_matches_jax():
    from piv_liteflownet_tpu.stereo.vel3d import willert

    rng = np.random.default_rng(0)
    flows = [rng.standard_normal((16, 20, 2)).astype(np.float32) for _ in range(2)]
    for theta, beta in (((np.deg2rad(-45.0), np.deg2rad(45.0)), (np.deg2rad(-2.0), np.deg2rad(2.0))),
                        ((np.deg2rad(-30.0), np.deg2rad(40.0)), (0.0, 0.0))):
        got = vel3d.willert([torch.from_numpy(f) for f in flows], theta, beta)
        want = willert(flows, theta, beta)
        assert got.dtype == torch.float64 and got.shape == (16, 20, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_nl_trans_matches_jax():
    from piv_liteflownet_tpu.stereo.dewarp import nl_trans

    rng = np.random.default_rng(1)
    x, y = rng.uniform(-300, 300, (2, 50))
    for A in (DISTORT, _identity(), _identity(0.5) + 1e-4 * rng.standard_normal(24)):
        got = dewarp.nl_trans(torch.from_numpy(x.astype(np.float32)), torch.from_numpy(y), A)
        want = nl_trans(x.astype(np.float32), y, A)
        for g, w in zip(got, want):
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


def test_warp_image_matches_jax():
    from piv_liteflownet_tpu.stereo.dewarp import warp_image

    rng = np.random.default_rng(2)
    img = (rng.random((40, 52)) * 255).astype(np.uint8)
    pts = np.array([[3.0, 4.0], [20.5, 17.25]])
    for source in (img, img / 255.0):  # grey levels, and [0, 1] values the remap scales by 255
        for A in (_identity(), DISTORT, _identity(1.3)):
            got = dewarp.warp_image(torch.from_numpy(np.asarray(source)), pts, 1, A)
            assert got.dtype == torch.uint8
            np.testing.assert_array_equal(got.numpy(), warp_image(source, pts, 1, A))


@pytest.mark.parametrize("tc,hc,lc", [(5, 25, 25), (4, 25, 25), (3, 15, 21), (6, 20, 18)])
def test_gen_template_matches_jax(tc, hc, lc):
    from piv_liteflownet_tpu.stereo.matching import gen_template

    got = matching.gen_template(TC=tc, HC=hc, LC=lc)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, gen_template(TC=tc, HC=hc, LC=lc))


def test_grid_fit_and_reference_points_match_jax():
    from piv_liteflownet_tpu.stereo import dewarp as jdewarp
    from piv_liteflownet_tpu.stereo.matching import select_ref_points

    xs, ys = np.meshgrid(np.arange(7) * 20.0, np.arange(5) * 20.0)
    ideal = np.stack([xs.ravel(), ys.ravel()], 1) + np.array([50.0, 40.0])
    d = ideal - ideal.mean(0)
    distorted = ideal + 0.05 * d[:, ::-1] + 2e-4 * (d ** 2)
    clicks = [(52.0, 41.0), (171.0, 45.0), (175.0, 125.0), (47.0, 119.0)]
    got = matching.select_ref_points(distorted, clicks)
    want = select_ref_points(distorted, clicks)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]
    pt1 = got[1][0]
    new_pts = dewarp.grid_regularize(distorted, got[2], pt1)
    np.testing.assert_array_equal(new_pts, jdewarp.grid_regularize(distorted, want[2], pt1))
    np.testing.assert_array_equal(dewarp.map_coeff(distorted, new_pts, pt1),
                                  jdewarp.map_coeff(distorted, new_pts, pt1))


@pytest.mark.parametrize("noise", [0.0, 20.0])
def test_template_matching_matches_opencv(noise):
    pytest.importorskip("cv2")
    from piv_liteflownet_tpu.stereo import matching as jmatching

    img, centres = calibration_plate(200, 240, 40, DISTORT, noise=noise, seed=3)
    template = matching.gen_template()
    got = matching.template_matching(torch.from_numpy(img), template, threshold=0.7)
    want = jmatching.template_matching(img, template, threshold=0.7)
    assert got.dtype == torch.float32 and got.shape == want.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    got_c, want_c = matching.find_local_max(got), jmatching.find_local_max(want)
    assert len(got_c) == len(want_c) == len(centres)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-3)
    # every detection, seen through the plate's mapping (anchored at the image centre), lies
    # on a cross of the undistorted plate
    anchor = np.array([img.shape[1] / 2, img.shape[0] / 2])
    mx, my = dewarp.nl_trans(got_c[:, 0] - anchor[0], got_c[:, 1] - anchor[1], DISTORT)
    on_plate = np.stack([mx.numpy(), my.numpy()], 1) + anchor
    assert np.linalg.norm(on_plate[:, None] - centres[None], axis=2).min(1).max() < 1.5
    if noise == 0.0:  # the zero-padded border and the flat background: windows of variance 0
        padded = torch.nn.functional.pad(torch.from_numpy(img).double(), (12, 12, 12, 12))
        raw = matching._ccoeff_normed(padded, torch.from_numpy(template).double())
        sums = matching._window_sums(padded * padded, 25, 25)
        flat = sums == 0
        assert flat.any() and bool((raw[flat] == 0).all())


def _write_plate(root, name, noise, seed):
    for cam, shift in (("-L", 0), ("-R", 5)):
        A = DISTORT.copy()
        A[2] = shift
        img, centres = calibration_plate(240, 280, 40, A, noise=noise, seed=seed)
        Image.fromarray(img).save(os.path.join(root, f"{name}{cam}.png"))
    return centres


def test_stereo_cal_matches_jax(tmp_path, monkeypatch):
    """The port's detection finds OpenCV's crosses within 1e-3 px; given OpenCV's crosses, the
    rest of the CLI (reference points, grid, fit, file) gives JAX's mappings within 0.01 px.

    Not the port's detection end to end at 0.01 px: JAX's ``map_coeff`` stops its 24-coefficient
    Nelder-Mead at the iteration cap, and moving the detected centres by 1e-7 px moves its own
    mapping by more than 0.01 px on this plate.
    """
    from piv_liteflownet_tpu.stereo import matching as jmatching

    jcal = _repo_module("stereo_cal")
    centres = _write_plate(str(tmp_path), "plate", 8.0, 4)
    # one cell of the plate's grid (6 crosses a row), clockwise from the top left: its sides
    # give the grid's spacing
    cell = [centres[0], centres[1], centres[7], centres[6]]
    clicks = [str(c) for xy in cell for c in xy]
    argv = ["--root", str(tmp_path), "--name", "plate", "--clicks", *clicks, "--calib", "0.002"]
    jcal.main(argv + ["--save", str(tmp_path / "jax")])
    want = json.loads((tmp_path / "jax" / "plate_coeff.json").read_text())

    def opencv_crosses(gray, args, device):
        template = jmatching.gen_template(*args.template)
        return jmatching.find_local_max(jmatching.template_matching(gray, template, args.threshold))

    got = port_cal.main(argv + ["--save", str(tmp_path / "port"), "--cpu"])
    with monkeypatch.context() as m:
        m.setattr(port_cal, "detect_crosses", opencv_crosses)
        given = port_cal.main(argv + ["--save", str(tmp_path / "given"), "--cpu"])
    written = json.loads((tmp_path / "given" / "plate_coeff.json").read_text())
    assert written == {k: v for k, v in given.items() if k != "points"}
    assert set(written) == set(want) == {"Left", "Right", "calib"} and written["calib"] == 0.002
    for cam, tag in (("Left", "-L"), ("Right", "-R")):
        coords = got["points"][cam][0]
        gray = np.asarray(Image.open(tmp_path / f"plate{tag}.png").convert("L"))
        cv_coords = opencv_crosses(gray, port_cal.build_parser().parse_args([]), None)
        assert len(coords) == len(cv_coords) == len(centres)
        np.testing.assert_allclose(coords, cv_coords, rtol=0, atol=1e-3)
        _, new_pts, pt1 = given["points"][cam]
        rel = new_pts - new_pts[pt1]
        mx, my = dewarp.nl_trans(rel[:, 0], rel[:, 1], written[cam])
        jx, jy = dewarp.nl_trans(rel[:, 0], rel[:, 1], want[cam])
        assert float(torch.hypot(mx - jx, my - jy).max()) < 0.01, cam


def _coeff_file(path, calib=None):
    coeff = {"Left": list(DISTORT), "Right": list(_identity(0.9))}
    if calib is not None:
        coeff["calib"] = calib
    path.write_text(json.dumps(coeff))
    return str(path)


def test_flo_process_matches_jax(tmp_path):
    jrun = _repo_module("stereo_run")
    save = tmp_path / "work"
    rng = np.random.default_rng(5)
    for cam, tag in (("left", "L"), ("right", "R")):
        (save / cam).mkdir(parents=True)
        for base in ("a01", "a02"):
            write_flow((4 * rng.standard_normal((24, 20, 2))).astype(np.float32),
                       str(save / cam / f"{base}-{tag}_out.flo"))
    argv = ["--coeff", _coeff_file(tmp_path / "c.json", calib=0.5), "--save", str(save),
            "--theta", "40", "35", "--alpha", "3", "--calib", "0.25", "--fps", "7"]
    jrun.flo_process(jrun.build_parser().parse_args(argv))
    want = {p: read_flow(p, use_stereo=True) for p in sorted(map(str, (save / "stereo").iterdir()))}
    got = port_run.main(argv + ["--cpu"])
    assert sorted(got) == list(want)
    for path in got:
        out = read_flow(path, use_stereo=True)
        assert out.shape == (24, 20, 3)
        np.testing.assert_array_max_ulp(out, want[path], maxulp=1)


def _write_stereo_pairs(root, n, h, w, seed):
    """``n`` stereo PIV pairs ``<base>-L_img{1,2}.png`` / ``<base>-R_img{1,2}.png``, the right
    view shifted the other way."""
    for cam, tag, sign in (("left", "L", 1.0), ("right", "R", -1.0)):
        os.makedirs(os.path.join(root, cam), exist_ok=True)
        im1, im2 = particle_pair(n, h, w, seed, shift=(1.5 * sign, 0.5), density=0.05)
        for i in range(n):
            for k, im in ((1, im1[i]), (2, im2[i])):
                Image.fromarray((im * 255).astype(np.uint8)).save(
                    os.path.join(root, cam, f"s{i:02d}-{tag}_img{k}.png"))


def test_stereo_run_direct_and_manual_match_jax(tmp_path):
    from piv_liteflownet_tpu.models.factory import piv_liteflownet as jax_piv

    jrun = _repo_module("stereo_run")
    weights = str(tmp_path / "w.npz")
    np.savez(weights, **{k: np.asarray(v) for k, v in jax_piv(version=1, seed=3).params.items()})
    root = str(tmp_path / "imgs")
    _write_stereo_pairs(root, 1, 64, 64, seed=6)
    coeff = _coeff_file(tmp_path / "c.json", calib=2.0)
    argv = ["--coeff", coeff, "--root", root, "--model", weights, "--theta", "45", "--calib", "4.0"]
    jrun.main(argv + ["--save", str(tmp_path / "jax"), "--inference-mode", "direct"])
    want = read_flow(str(tmp_path / "jax" / "stereo" / "s00-S_out.flo"), use_stereo=True)
    direct = port_run.main(argv + ["--save", str(tmp_path / "direct"), "--inference-mode", "direct", "--cpu"])
    manual = port_run.main(argv + ["--save", str(tmp_path / "manual"), "--cpu"])
    assert [os.path.basename(p) for p in direct] == [os.path.basename(p) for p in manual] == ["s00-S_out.flo"]
    got = read_flow(direct[0], use_stereo=True)
    assert got.shape == want.shape == (64, 64, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(read_flow(manual[0], use_stereo=True), got, rtol=0, atol=1e-4)
    with pytest.raises(FileNotFoundError):
        port_run.main(["--coeff", coeff, "--root", root, "--model", str(tmp_path / "none.npz"), "--cpu"])
