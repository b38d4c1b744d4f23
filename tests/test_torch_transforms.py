"""The port's on-device augmentation against the JAX package's, given JAX's own draws.

Torch's and JAX's random streams differ, so the port splits drawing
(``draw_params``) from applying (``augment``). ``_jax_draws`` takes the draws
of JAX ``apply_pipeline`` for a key, through JAX's ``_sample_geometry`` and
the same ``jax.random`` calls in the same order; the port's ``augment`` of
them must equal JAX ``apply_pipeline`` of that key: atol 1e-5 (float32
sampling in another summation order; the blur is a conv in another order).
Shapes are small (b4, 48x64 frames, 32x48 crops) and cover the default
train pipeline, a crop larger than the frame (clamped, and with
``pad_fill``), rotation (the gather path), blur with normalize, the flow-less
path, and ``resample="gather"`` against ``"auto"``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch.data import transforms as T
from piv_liteflownet_tpu_torch.data.datasets import get_transform

ATOL = 1e-5
B, H, W = 4, 48, 64
CROP = (32, 48)
PHOTO = T.Photometric(noise_std_range=(0.0, 0.04), contrast_range=(-0.8, 0.4), brightness_sigma=0.2,
                      color_range=(0.5, 2.0), gamma_range=(0.7, 1.5))

PIPES = {
    "default train": get_transform(crop_size=CROP, mode="train"),
    "default val": get_transform(crop_size=CROP, mode="val"),
    "oversized crop, clamped": get_transform(crop_size=(H, W), mode="train"),
    "oversized crop, pad_fill": T.Pipeline(crop_size=(56, 72), translate=10, scale_range=(0.9, 1.1),
                                           hflip=True, pad_fill=(0.2, 0.3, 0.4)),
    "rotation": T.Pipeline(crop_size=CROP, translate=8, scale_range=(0.9, 1.3), rotate=12.0,
                           hflip=True, vflip=True, photometric=PHOTO),
    "center crop, blur, normalize": T.Pipeline(crop_size=CROP, crop_type="center", scale_range=(1.0, 1.4),
                                               blur_radius=1.5, blur_prob=0.5,
                                               normalize_mean=(0.4, 0.5, 0.6), normalize_std=(0.2, 0.25, 0.3)),
    "gather": dataclasses.replace(get_transform(crop_size=CROP, mode="train"), resample="gather"),
}


def _jax_pipe(pipe: T.Pipeline):
    from piv_liteflownet_tpu.data import transforms as JT

    fields = {f.name: getattr(pipe, f.name) for f in dataclasses.fields(pipe)}
    if pipe.photometric is not None:
        fields["photometric"] = JT.Photometric(**dataclasses.asdict(pipe.photometric))
    return JT.Pipeline(**fields)


def _jax_draws(key, jpipe, b, h, w):
    """The factors JAX ``apply_pipeline(key, ...)`` draws, as the port's ``draw_params`` dict."""
    import jax

    from piv_liteflownet_tpu.data.transforms import _sample_geometry

    ch, cw = jpipe.crop_size
    rows = []
    for k in jax.random.split(key, b):
        kg, kp = jax.random.split(k)
        row = {n: np.asarray(v) for n, v in _sample_geometry(kg, jpipe, h, w).items()}
        ph = jpipe.photometric
        if ph is not None:
            kk = jax.random.split(kp, 5)
            row["contrast"] = jax.random.uniform(kk[0], (), minval=ph.contrast_range[0], maxval=ph.contrast_range[1])
            row["gamma"] = jax.random.uniform(kk[1], (), minval=ph.gamma_range[0], maxval=ph.gamma_range[1])
            row["color"] = jax.random.uniform(kk[2], (3,), minval=ph.color_range[0], maxval=ph.color_range[1])
            row["brightness"] = jax.random.normal(kk[3], ()) * ph.brightness_sigma
            row["noise_std"] = jax.random.uniform(kk[4], (), minval=ph.noise_std_range[0],
                                                  maxval=ph.noise_std_range[1])
            knoise = jax.random.fold_in(kk[4], 1)
            row["noise"] = np.stack([jax.random.normal(jax.random.fold_in(knoise, i), (ch, cw, 3))
                                     for i in (0, 1)])
        if jpipe.blur_radius > 0.0:
            row["blur"] = jax.random.bernoulli(jax.random.fold_in(kp, 7), jpipe.blur_prob)
        rows.append(row)
    return {n: torch.from_numpy(np.stack([np.asarray(r[n]) for r in rows])) for n in rows[0]}


def _inputs(seed, b=B, h=H, w=W):
    rng = np.random.default_rng(seed)
    img1 = rng.random((b, h, w, 3), dtype=np.float32)
    img2 = rng.random((b, h, w, 3), dtype=np.float32)
    flow = (3.0 * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    return img1, img2, flow


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", list(PIPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_with_jax_draws_matches_jax(name, seed):
    import jax

    from piv_liteflownet_tpu.data.transforms import apply_pipeline as japply

    pipe = PIPES[name]
    jpipe = _jax_pipe(pipe)
    img1, img2, flow = _inputs(seed)
    key = jax.random.PRNGKey(100 + seed)
    want = [np.asarray(a) for a in japply(key, img1, img2, flow, jpipe)]
    params = _jax_draws(key, jpipe, B, H, W)
    got = T.augment(params, *_t(img1, img2, flow), pipe)
    assert [tuple(g.shape) for g in got] == [a.shape for a in want]
    for g, a in zip(got, want):
        np.testing.assert_allclose(g.numpy(), a, atol=ATOL, rtol=0)
    if name.startswith("default train"):
        # the draws reach both flip branches, so both mirrorings are checked
        assert set(params["fh"].tolist()) | set(params["fv"].tolist()) == {True, False}


def test_augment_without_flow_matches_jax():
    import jax

    from piv_liteflownet_tpu.data.transforms import apply_pipeline as japply

    pipe = PIPES["rotation"]
    jpipe = _jax_pipe(pipe)
    img1, img2, _ = _inputs(3)
    key = jax.random.PRNGKey(7)
    want = japply(key, img1, img2, None, jpipe)
    got = T.augment(_jax_draws(key, jpipe, B, H, W), *_t(img1, img2), None, pipe)
    assert len(got) == 2
    for g, a in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["default train", "oversized crop, pad_fill"])
def test_gather_resample_equals_separable(name):
    pipe = PIPES[name]
    img1, img2, flow = _inputs(5)
    params = T.draw_params(pipe, B, H, W, torch.Generator().manual_seed(3))
    sep = T.augment(params, *_t(img1, img2, flow), pipe)
    gat = T.augment(params, *_t(img1, img2, flow), dataclasses.replace(pipe, resample="gather"))
    for a, b in zip(sep, gat):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_draw_params_shapes_ranges_and_seeding():
    pipe = dataclasses.replace(PIPES["default train"], blur_radius=1.0)
    p = T.draw_params(pipe, 64, H, W, torch.Generator().manual_seed(0))
    q = T.draw_params(pipe, 64, H, W, torch.Generator().manual_seed(0))
    assert p.keys() == q.keys() and all(torch.equal(p[k], q[k]) for k in p)
    assert p["noise"].shape == (64, 2) + CROP + (3,) and p["color"].shape == (64, 3)
    assert p["fh"].dtype == torch.bool and p["blur"].dtype == torch.bool
    assert (p["tw"].abs() <= 16 * W / 100).all() and torch.equal(p["tw"], torch.floor(p["tw"]))
    assert ((p["s"] >= 0.95) & (p["s"] <= 1.45)).all()
    sw = (W - p["tw"].abs()) * p["s"]
    assert ((p["ox"] >= 0) & (p["ox"] <= torch.clamp(sw - CROP[1], min=0))).all()
    assert ((p["gamma"] >= 0.7) & (p["gamma"] <= 1.5)).all()
    # a seed draws on the images' device and gives the generator's draws
    img1, img2, flow = _t(*_inputs(0))
    out = T.apply_pipeline(11, img1, img2, flow, pipe)
    again = T.augment(T.draw_params(pipe, B, H, W, torch.Generator().manual_seed(11)), img1, img2, flow, pipe)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_pipeline_rejects_unknown_resample():
    with pytest.raises(ValueError, match="resample"):
        T.Pipeline(resample="matmul")


@pytest.mark.parametrize("radius", [0.6, 2.0])
def test_gaussian_blur_and_normalize_match_jax(radius):
    from piv_liteflownet_tpu.data import transforms as JT

    img = np.random.default_rng(2).random((2, 20, 24, 3), dtype=np.float32)
    np.testing.assert_allclose(T.gaussian_blur(torch.from_numpy(img), radius).numpy(),
                               np.asarray(JT.gaussian_blur(img, radius)), atol=ATOL, rtol=0)
    mean, std = (0.1, 0.2, 0.3), (0.5, 0.6, 0.7)
    np.testing.assert_allclose(T.normalize(torch.from_numpy(img), mean, std).numpy(),
                               np.asarray(JT.normalize(img, mean, std)), atol=1e-6, rtol=0)


def test_get_transform_matches_jax():
    from piv_liteflownet_tpu.data.datasets import get_transform as jget

    for mode in ("train", "val"):
        assert _jax_pipe(get_transform(crop_size=CROP, mode=mode)) == jget(crop_size=CROP, mode=mode)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_augment_on_the_card_matches_the_cpu_under_default_tf32_flags(cuda):
    pipe = dataclasses.replace(PIPES["default train"], blur_radius=1.5)
    img1, img2, flow = _t(*_inputs(9))
    params = T.draw_params(pipe, B, H, W, torch.Generator().manual_seed(4))
    want = T.augment(params, img1, img2, flow, pipe)
    got = T.augment(params, img1.to(cuda), img2.to(cuda), flow.to(cuda), pipe)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=ATOL, rtol=0)
