"""Middlebury ``.flo`` I/O (port of ``piv_liteflownet_tpu/utils/flow_io.py``).

Byte contract: ``float32 tag 202021.25 | int32 width | int32 height |
float32[h*w*bands]`` with 2 bands (u, v) or 3 bands (u, v, w) for stereo.
"""

from __future__ import annotations

import os

import numpy as np

TAG_FLOAT = 202021.25
IMAGE_EXTS = ("jpg", "jpeg", "png", "bmp", "tif", "ppm", "pgm")


def read_flow(filename: str, use_stereo: bool = False) -> np.ndarray:
    """Read a ``.flo`` file; returns float32 ``[H,W,2]`` (``[H,W,3]`` stereo)."""
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
    return data.reshape(height, width, n_bands).copy()


def write_flow(flow: np.ndarray, filename: str) -> None:
    """Write a 2- or 3-band ``[H,W,bands]`` flow as a ``.flo`` file."""
    if not filename.endswith(".flo"):
        raise ValueError(f"file ending is not .flo ({filename!r})")
    flow = np.asarray(flow)
    if flow.ndim != 3 or flow.shape[2] not in (2, 3):
        raise ValueError(f"expected [H,W,2] or [H,W,3], got {flow.shape}")
    height, width, _ = flow.shape
    with open(filename, "wb") as f:
        np.array([TAG_FLOAT], dtype=np.float32).tofile(f)
        np.array([width, height], dtype=np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def flowname_modifier(indir: str, outdir: str, ext: str = "_out.flo", pair: bool = True) -> str:
    """``<base>_img1.png -> <outdir>/<base>_out.flo`` (``pair``), else ``<name>_out.flo``."""
    out_name = os.path.splitext(os.path.basename(indir))[0]
    if pair:
        out_name = out_name.rsplit("_", 1)[0]
    return os.path.join(outdir, out_name + ext)


def image_files(folder: str) -> list[str]:
    """Images in ``folder``, sorted by name."""
    files = [os.path.join(folder, f) for f in sorted(os.listdir(folder))]
    return [f for f in files if os.path.splitext(f)[1].lower().lstrip(".") in IMAGE_EXTS]


def image_pairs(folder: str, is_pair: bool, start: int = 0, n_images: int = -1) -> list[tuple[str, str]]:
    """Frame pairs of an inference directory.

    ``is_pair``: every ``*_img1.*`` with an ``*_img2.*`` sibling; otherwise
    consecutive frames. ``start``/``n_images`` slice the file list first.
    """
    files = image_files(folder)
    if is_pair:
        files = [f for f in files if os.path.splitext(f)[0].endswith("_img1")]
    files = files[start:] if n_images < 0 else files[start:start + n_images]
    if not is_pair:
        return list(zip(files[:-1], files[1:]))
    pairs = []
    for f1 in files:
        base, ext = os.path.splitext(f1)
        f2 = base.rsplit("_", 1)[0] + "_img2" + ext
        if os.path.isfile(f2):
            pairs.append((f1, f2))
    return pairs
