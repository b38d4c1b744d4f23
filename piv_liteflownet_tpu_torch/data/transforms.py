"""On-device augmentation of training batches (port of ``piv_liteflownet_tpu/data/transforms.py``).

The default pipeline Translate -> Scale -> HFlip -> VFlip -> RandomCrop is
one affine coordinate map per sample, so each image (and the flow) is
sampled once, bilinearly, at the crop's resolution:

- Translate(t %): img1 and img2 shifted oppositely, flow += (tw, th);
- Scale(s): images resampled, flow resampled and multiplied by s;
- H/V flip: the output grid mirrored and u/v negated;
- crop at a random (or the centre) offset; a crop larger than the frame
  samples clamped to the frame's edge, or with ``pad_fill`` centres the frame
  in a border of that colour (flow 0);
- rotation through the same sampling, with the flow rotated back;
- photometric: per sample ``clamp((im*(c+1)+b)*color)^(1/gamma) + noise``;
- a Gaussian blur of both frames with probability ``blur_prob``;
- ``normalize``: ``(im - mean) / std``.

Torch's random stream is not JAX's, so drawing is split from applying:
:func:`draw_params` draws a batch's random factors from an explicit
``torch.Generator`` (on the generator's device), and :func:`augment` applies
given factors; :func:`apply_pipeline` does both. Given JAX's draws,
:func:`augment` computes JAX's ``apply_pipeline``. Batches are NHWC, as in
JAX. Without rotation the sampling is separable (``resample="auto"``):
rows, then columns, two taps each, the taps and weights of JAX's
interpolation matrices; ``"gather"`` takes the four taps at once. Both are
gathers and elementwise sums, and the blur runs in full float32
(``ops/nn.py:f32_convs``), so no TF32 flag reaches the result.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from piv_liteflownet_tpu_torch.ops.nn import f32_convs

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Photometric:
    noise_std_range: Tuple[float, float] = (0.0, 0.0)
    contrast_range: Tuple[float, float] = (0.0, 0.0)
    brightness_sigma: float = 0.0
    color_range: Tuple[float, float] = (1.0, 1.0)
    gamma_range: Tuple[float, float] = (1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Pipeline:
    crop_size: Tuple[int, int] = (256, 256)
    crop_type: str = "rand"  # or "center"
    translate: int = 0  # percent of each dimension
    scale_range: Optional[Tuple[float, float]] = None
    rotate: float = 0.0  # max |angle|, degrees
    rotate_diff: float = 0.0
    hflip: bool = False
    vflip: bool = False
    photometric: Optional[Photometric] = None
    # a crop larger than the (translated, scaled) frame: None samples clamped to the
    # frame's edge; an rgb triple in [0, 1] centres the frame in a border of that colour
    # (flow 0)
    pad_fill: Optional[Tuple[float, float, float]] = None
    blur_radius: float = 0.0  # Gaussian blur of both frames, with probability blur_prob
    blur_prob: float = 0.5
    normalize_mean: Optional[Tuple[float, ...]] = None  # the last stage: (im - mean) / std
    normalize_std: Optional[Tuple[float, ...]] = None
    # "auto": the separable sampling unless the geometry rotates; "gather": four taps
    # at once always. The same taps and weights, equal up to float32 summation order.
    resample: str = "auto"

    def __post_init__(self):
        if self.resample not in ("auto", "gather"):
            raise ValueError(f"Pipeline.resample must be 'auto' or 'gather', got {self.resample!r}")


def _oob(coord: torch.Tensor, size: int) -> torch.Tensor:
    return (coord < -0.5) | (coord > size - 0.5)


def _fill(out: torch.Tensor, oob: torch.Tensor, fill) -> torch.Tensor:
    fill_t = torch.as_tensor(np.asarray(fill, np.float32), device=out.device)
    return torch.where(oob[..., None], fill_t, out)


def _bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, fill=None) -> torch.Tensor:
    """``img [B,H,W,C]`` sampled bilinearly at ``x, y [B,h,w]``, coordinates clamped to the
    frame; with ``fill``, samples outside it take the fill vector instead."""
    b, h, w, c = img.shape
    oob = (_oob(x, w) | _oob(y, h)) if fill is not None else None
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    # one zero row and column past the edge: x == w-1 gives wx == 0, so the padded tap
    # never carries weight (same for y)
    imgp = F.pad(img, (0, 0, 0, 1, 0, 1))
    bi = torch.arange(b, device=img.device).view(b, 1, 1)
    out = (imgp[bi, y0, x0] * ((1 - wx) * (1 - wy))
           + imgp[bi, y0, x0 + 1] * (wx * (1 - wy))
           + imgp[bi, y0 + 1, x0] * ((1 - wx) * wy)
           + imgp[bi, y0 + 1, x0 + 1] * (wx * wy))
    return out if oob is None else _fill(out, oob, fill)


def _lerp_axis(img: torch.Tensor, coord: torch.Tensor, axis: int) -> torch.Tensor:
    """Two-tap linear sampling of ``img [B,...]`` along ``axis`` at ``coord [B,n]``, clamped:
    the rows of JAX's ``_interp_matrix`` (taps ``i0`` and ``min(i0+1, size-1)``)."""
    size = img.shape[axis]
    c = torch.clamp(coord, 0.0, size - 1.0)
    i0 = torch.floor(c)
    frac = c - i0
    i0 = i0.long()
    i1 = torch.clamp(i0 + 1, max=size - 1)
    shape = [img.shape[0]] + [1] * (img.dim() - 1)
    shape[axis] = coord.shape[1]
    expand = list(img.shape)
    expand[axis] = coord.shape[1]

    def taps(i):
        return torch.gather(img, axis, i.view(shape).expand(expand))

    return taps(i0) * (1.0 - frac).view(shape) + taps(i1) * frac.view(shape)


def _bilinear_sample_sep(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, fill=None) -> torch.Tensor:
    """Separable :func:`_bilinear_sample` for axis-aligned maps: ``x [B,w]`` varies along
    columns only, ``y [B,h]`` along rows only; rows first, then columns, as JAX's two
    products."""
    h, w = img.shape[1], img.shape[2]
    out = _lerp_axis(_lerp_axis(img, y, 1), x, 2)
    if fill is None:
        return out
    return _fill(out, _oob(y, h)[:, :, None] | _oob(x, w)[:, None, :], fill)


def draw_params(pipe: Pipeline, b: int, h: int, w: int, generator: torch.Generator) -> Params:
    """Draw the random factors of a batch of ``b`` frames of ``h x w`` on the generator's
    device: the geometry of JAX's ``_sample_geometry`` (``tw th s fh fv ox oy ang``, each
    ``[b]``), and with ``pipe.photometric`` ``contrast gamma brightness noise_std [b]``,
    ``color [b,3]`` and ``noise [b,2,ch,cw,3]`` (unit normal, one field a frame), and with a
    blur ``blur [b]`` (bool)."""
    dev = generator.device
    ch, cw = pipe.crop_size

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((b,) + shape, generator=generator, device=dev)

    zeros = torch.zeros(b, device=dev)
    if pipe.translate:
        tw = torch.floor(uniform(-pipe.translate, pipe.translate) * w / 100.0)
        th = torch.floor(uniform(-pipe.translate, pipe.translate) * h / 100.0)
    else:
        tw = th = zeros
    s = uniform(*pipe.scale_range) if pipe.scale_range is not None else torch.ones(b, device=dev)
    fh = uniform(0.0, 1.0) < 0.5 if pipe.hflip else zeros.bool()
    fv = uniform(0.0, 1.0) < 0.5 if pipe.vflip else zeros.bool()
    # the scaled, translated frame must contain the crop
    sw = (w - tw.abs()) * s
    sh = (h - th.abs()) * s
    max_ox = torch.clamp(sw - cw, min=0.0)
    max_oy = torch.clamp(sh - ch, min=0.0)
    if pipe.crop_type == "rand":
        ox = uniform(0.0, 1.0) * max_ox
        oy = uniform(0.0, 1.0) * max_oy
    else:
        ox, oy = max_ox / 2.0, max_oy / 2.0
    if pipe.pad_fill is not None:
        # an oversized crop centres the frame in the fill border
        ox = ox + torch.clamp(sw - cw, max=0.0) / 2.0
        oy = oy + torch.clamp(sh - ch, max=0.0) / 2.0
    ang = uniform(-pipe.rotate, pipe.rotate) if pipe.rotate else zeros
    params = dict(tw=tw, th=th, s=s, fh=fh, fv=fv, ox=ox, oy=oy, ang=ang)
    ph = pipe.photometric
    if ph is not None:
        params.update(
            contrast=uniform(*ph.contrast_range), gamma=uniform(*ph.gamma_range),
            color=uniform(*ph.color_range, 3),
            brightness=torch.randn(b, generator=generator, device=dev) * ph.brightness_sigma,
            noise_std=uniform(*ph.noise_std_range),
            noise=torch.randn((b, 2, ch, cw, 3), generator=generator, device=dev))
    if pipe.blur_radius > 0.0:
        params["blur"] = uniform(0.0, 1.0) < pipe.blur_prob
    return params


def _col(v: torch.Tensor, nd: int) -> torch.Tensor:
    """A ``[B]`` or ``[B,k]`` factor shaped to broadcast over ``[B, ...]`` of ``nd`` dims."""
    return v.view(v.shape[0], *([1] * (nd - v.dim())), *v.shape[1:])


def augment(params: Params, img1: torch.Tensor, img2: torch.Tensor, flow: Optional[torch.Tensor],
            pipe: Pipeline):
    """Apply drawn factors (:func:`draw_params`) to ``img1, img2 [B,H,W,3]`` and ``flow
    [B,H,W,2]`` (or None), on their device: the cropped ``[B,ch,cw,3]`` pair and
    ``[B,ch,cw,2]`` flow (or the pair alone)."""
    b, h, w = img1.shape[:3]
    ch, cw = pipe.crop_size
    dev = img1.device
    p = {k: v.to(dev) for k, v in params.items()}
    tw, th, s = p["tw"], p["th"], p["s"]
    sep = (not pipe.rotate) and pipe.resample != "gather"
    xo = torch.arange(cw, dtype=torch.float32, device=dev).expand(b, cw)
    yo = torch.arange(ch, dtype=torch.float32, device=dev).expand(b, ch)
    # flips mirror the output grid (the flow's components are negated below)
    xo = torch.where(p["fh"][:, None], cw - 1.0 - xo, xo)
    yo = torch.where(p["fv"][:, None], ch - 1.0 - yo, yo)
    # the crop offset, then the inverse scale (half-pixel convention), then the rotation
    xs = (xo + p["ox"][:, None] + 0.5) / s[:, None] - 0.5
    ys = (yo + p["oy"][:, None] + 0.5) / s[:, None] - 0.5
    if not sep:
        xs = xs[:, None, :].expand(b, ch, cw)
        ys = ys[:, :, None].expand(b, ch, cw)
    if pipe.rotate:
        rad = p["ang"] * math.pi / 180.0
        cx = _col((w - tw.abs()) / 2.0, 3)
        cy = _col((h - th.abs()) / 2.0, 3)
        ca, sa = _col(torch.cos(rad), 3), _col(torch.sin(rad), 3)
        xs, ys = ca * (xs - cx) - sa * (ys - cy) + cx, sa * (xs - cx) + ca * (ys - cy) + cy
    sample = _bilinear_sample_sep if sep else _bilinear_sample
    nd = 2 if sep else 3
    # translate: the img1 window starts at (max(0,tw), max(0,th)), img2's at (max(0,-tw), ...)
    ax, ay = _col(torch.clamp(tw, min=0.0), nd), _col(torch.clamp(th, min=0.0), nd)
    bx, by = _col(torch.clamp(-tw, min=0.0), nd), _col(torch.clamp(-th, min=0.0), nd)
    fill = pipe.pad_fill
    out2 = sample(img2, xs + bx, ys + by, fill=fill)
    new_flow = None
    if flow is None:
        out1 = sample(img1, xs + ax, ys + ay, fill=fill)
    else:
        # img1 and the flow share one sample grid: one sampling of their concat
        c1 = img1.shape[-1]
        fill_c = None
        if fill is not None:
            fill_c = np.concatenate([np.broadcast_to(np.asarray(fill, np.float32), (c1,)),
                                     np.zeros((flow.shape[-1],), np.float32)])
        comb = sample(torch.cat([img1, flow.to(img1.dtype)], dim=-1), xs + ax, ys + ay, fill=fill_c)
        out1, f = comb[..., :c1], comb[..., c1:]
        f = f + _col(torch.stack([tw, th], dim=-1), 4)  # the translate offset
        f = f * _col(s, 4)  # scaling scales u and v
        if pipe.rotate:
            ca, sa = _col(torch.cos(rad), 3), _col(torch.sin(rad), 3)
            f = torch.stack([ca * f[..., 0] + sa * f[..., 1], -sa * f[..., 0] + ca * f[..., 1]], dim=-1)
        one = torch.ones_like(tw)
        signs = torch.stack([torch.where(p["fh"], -one, one), torch.where(p["fv"], -one, one)], dim=-1)
        new_flow = f * _col(signs, 4)

    if pipe.photometric is not None:
        contrast, brightness = _col(p["contrast"], 4), _col(p["brightness"], 4)
        color, gamma = _col(p["color"], 4), _col(p["gamma"], 4)
        noise_std = _col(p["noise_std"], 4)

        def photo(im, i):
            im = torch.clamp((im * (contrast + 1.0) + brightness) * color, 0.0, 1.0)
            return torch.pow(im, 1.0 / gamma) + p["noise"][:, i] * noise_std

        out1, out2 = photo(out1, 0), photo(out2, 1)

    if pipe.blur_radius > 0.0:
        blur = _col(p["blur"], 4)
        out1 = torch.where(blur, gaussian_blur(out1, pipe.blur_radius), out1)
        out2 = torch.where(blur, gaussian_blur(out2, pipe.blur_radius), out2)

    if pipe.normalize_mean is not None:
        std = pipe.normalize_std if pipe.normalize_std is not None else (1.0,) * 3
        out1 = normalize(out1, pipe.normalize_mean, std)
        out2 = normalize(out2, pipe.normalize_mean, std)
    return (out1, out2) if flow is None else (out1, out2, new_flow)


def apply_pipeline(rng: Union[int, torch.Generator], img1: torch.Tensor, img2: torch.Tensor,
                   flow: Optional[torch.Tensor], pipe: Pipeline):
    """Draw with ``rng`` (a ``torch.Generator``, or a seed for a generator on the images'
    device) and apply: :func:`draw_params` then :func:`augment`."""
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator(device=img1.device).manual_seed(int(rng))
    b, h, w = img1.shape[:3]
    return augment(draw_params(pipe, b, h, w, rng), img1, img2, flow, pipe)


def gaussian_blur(img: torch.Tensor, radius: float = 2.0) -> torch.Tensor:
    """PIL-style Gaussian blur of ``[B,H,W,C]``: a vertical then a horizontal depthwise conv of
    ``2r+1`` taps, ``r = max(1, int(2 radius))``, zero padded; full float32 convs."""
    r = max(1, int(2 * radius))
    xs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / radius) ** 2)
    k /= k.sum()
    c = img.shape[-1]
    kern = torch.as_tensor(k, device=img.device, dtype=img.dtype)
    x = img.permute(0, 3, 1, 2)
    with f32_convs():
        x = F.conv2d(x, kern.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(r, 0), groups=c)
        x = F.conv2d(x, kern.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, r), groups=c)
    return x.permute(0, 2, 3, 1)


def normalize(img: torch.Tensor, mean, std) -> torch.Tensor:
    """``(im - mean) / std`` per channel."""
    mean = torch.as_tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.as_tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std
