"""Middlebury ``.flo`` I/O and flow-array helpers (port of ``piv_liteflownet_tpu/utils/flow_io.py``).

Byte contract: ``float32 tag 202021.25 | int32 width | int32 height |
float32[h*w*bands]`` with 2 bands (u, v) or 3 bands (u, v, w) for stereo.
"""

from __future__ import annotations

import os
import re
from glob import glob
from typing import List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

TAG_FLOAT = 202021.25
UNKNOWN_FLOW_THRESH = 1e9
IMAGE_EXTS = ("jpg", "jpeg", "png", "bmp", "tif", "ppm", "pgm")

CropWindow = Union[int, Tuple[int, int, int, int]]


def _crop(flow: np.ndarray, crop_window: CropWindow = 0) -> np.ndarray:
    """Drop (top, bottom, left, right) margins; an int drops that many on every side."""
    if isinstance(crop_window, int):
        if crop_window == 0:
            return flow
        crop_window = (crop_window,) * 4
    t, b, l, r = crop_window
    h, w = flow.shape[:2]
    return flow[t:h - b if b else h, l:w - r if r else w]


def read_flow(filename: str, use_stereo: bool = False, crop_window: CropWindow = 0) -> np.ndarray:
    """Read a ``.flo`` file; returns float32 ``[H,W,2]`` (``[H,W,3]`` stereo), less the
    ``crop_window`` margins."""
    if not os.path.isfile(filename):
        raise FileNotFoundError(f"Path [{filename}] does not exist")
    if not filename.endswith(".flo"):
        raise ValueError(f"File extension [flo] required, got [{filename}]")
    with open(filename, "rb") as flo:
        tag = np.frombuffer(flo.read(4), np.float32, count=1)[0]
        if tag != np.float32(TAG_FLOAT):
            raise ValueError(f"Wrong Tag [{tag}]")
        width = int(np.frombuffer(flo.read(4), np.int32, count=1)[0])
        height = int(np.frombuffer(flo.read(4), np.int32, count=1)[0])
        if not (0 < width < 100000 and 0 < height < 100000):
            raise ValueError(f"Illegal size [{width}x{height}]")
        n_bands = 3 if use_stereo else 2
        size = n_bands * width * height
        data = np.frombuffer(flo.read(size * 4), np.float32, count=size)
    return _crop(data.reshape(height, width, n_bands).copy(), crop_window)


def write_flow(flow: np.ndarray, filename: str, norm: bool = False) -> None:
    """Write a 2- or 3-band ``[H,W,bands]`` flow as a ``.flo`` file; ``norm`` divides it by
    its largest (u, v) magnitude first."""
    if not filename.endswith(".flo"):
        raise ValueError(f"file ending is not .flo ({filename!r})")
    flow = np.asarray(flow)
    if flow.ndim != 3 or flow.shape[2] not in (2, 3):
        raise ValueError(f"expected [H,W,2] or [H,W,3], got {flow.shape}")
    if norm:
        mag = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2).max()
        if mag > 0:
            flow = flow / mag
    height, width, _ = flow.shape
    with open(filename, "wb") as f:
        np.array([TAG_FLOAT], dtype=np.float32).tofile(f)
        np.array([width, height], dtype=np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_flow_collection(dirname: str, start_at: int = 0, num_images: int = -1,
                         use_stereo: bool = False,
                         crop_window: CropWindow = 0) -> Tuple[np.ndarray, List[str]]:
    """Every ``.flo`` of ``dirname`` ordered by the last number in its name, sliced by
    ``start_at``/``num_images``: the stacked flows and their paths."""
    pattern = re.compile(r"\d+")
    files = []
    for f in os.listdir(dirname):
        if f.endswith(".flo"):
            match = pattern.findall(f)
            if match:
                files.append((int(match[-1]), os.path.join(dirname, f)))
    files.sort(key=lambda x: x[0])
    files = files[start_at:] if num_images < 0 else files[start_at:start_at + num_images]
    flonames = [path for _, path in files]
    flos = [read_flow(path, use_stereo=use_stereo, crop_window=crop_window) for path in flonames]
    return np.array(flos), flonames


def unknown_flow(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Where a flow is unknown: a component beyond 1e9 in magnitude, or NaN."""
    return ((np.fabs(u) > UNKNOWN_FLOW_THRESH) | (np.fabs(v) > UNKNOWN_FLOW_THRESH)
            | np.isnan(u) | np.isnan(v))


def resize_flow(flow: np.ndarray, des_width: int, des_height: int, method: str = "bilinear") -> np.ndarray:
    """Resize a dense ``[H,W,2]`` flow, u scaled by the width ratio and v by the height ratio.

    "bilinear" samples at half-pixel centres without antialiasing and "nearest" takes
    ``floor(dst * src / dst_size)``: the sampling of OpenCV's ``INTER_LINEAR`` and
    ``INTER_NEAREST``, which the JAX package calls.
    """
    src_height, src_width = flow.shape[:2]
    if src_width == des_width and src_height == des_height:
        return flow
    modes = {"bilinear": dict(mode="bilinear", align_corners=False), "nearest": dict(mode="nearest")}
    if method not in modes:
        raise ValueError("Invalid resize flow method!")
    t = torch.from_numpy(np.ascontiguousarray(flow, np.float32)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(des_height, des_width), **modes[method])[0].permute(1, 2, 0).numpy().copy()
    out[:, :, 0] *= float(des_width) / float(src_width)
    out[:, :, 1] *= float(des_height) / float(src_height)
    return out


def horizontal_flip_flow(flow: np.ndarray) -> np.ndarray:
    """Mirror left-right and negate u."""
    flow = np.copy(np.fliplr(flow))
    flow[:, :, 0] *= -1
    return flow


def vertical_flip_flow(flow: np.ndarray) -> np.ndarray:
    """Mirror top-bottom and negate v."""
    flow = np.copy(np.flipud(flow))
    flow[:, :, 1] *= -1
    return flow


def flowname_modifier(indir: str, outdir: str, ext: str = "_out.flo", pair: bool = True) -> str:
    """``<base>_img1.png -> <outdir>/<base>_out.flo`` (``pair``), else ``<name>_out.flo``."""
    out_name = os.path.splitext(os.path.basename(indir))[0]
    if pair:
        out_name = out_name.rsplit("_", 1)[0]
    return os.path.join(outdir, out_name + ext)


def image_files_from_folder(folder: str, pair: bool = True, exts=IMAGE_EXTS) -> list[str]:
    """Images of ``folder`` grouped by extension in ``exts`` order, each group sorted; with
    ``pair`` only the ``*_img1.*`` files."""
    files = []
    for ext in exts:
        files += sorted(glob(os.path.join(folder, f"*.{ext}")))
    if pair:
        files = [f for f in files if os.path.splitext(f)[0].endswith("_img1")]
    return files
