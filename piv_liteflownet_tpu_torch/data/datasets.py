"""Datasets: inference directory scans and training stores (port of
``piv_liteflownet_tpu/data/datasets.py``).

- ``Run``: the frame pairs of a directory, ``*_img1.*``/``*_img2.*`` pairs or
  consecutive frames, sliced by ``start_at``/``n_images``.
- ``InferenceRun``: ``Run`` with a centre crop to a multiple of 64 and
  ``left``/``right`` stereo subdirectories.
- ``InferenceEval``: pairs with their ground-truth ``.flo``.
- ``PIVData``: ``<mode>*.json`` manifests of ``.flo`` paths, each beside its
  ``_img1``/``_img2`` frames.
- ``PIVH5`` (``h5py``) and ``PIVLMDB`` (``lmdb``): packed stores, each behind
  its optional import.

Every sample is numpy NHWC float32 in [0, 1] (flows ``[H,W,2]``); the loader
batches them and the train step augments them on the device
(``data/transforms.py``).
"""

from __future__ import annotations

import io
import json
import os
import pickle
from glob import glob
from typing import List, Optional, Tuple

import numpy as np

from piv_liteflownet_tpu_torch.utils.flow_io import read_flow

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".ppm", ".pgm")


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def _sorted_images(root: str) -> List[str]:
    files = [os.path.join(root, f) for f in sorted(os.listdir(root))]
    return [f for f in files if os.path.splitext(f)[1].lower() in IMG_EXTENSIONS]


def _floor_multiple(x: int, m: int) -> int:
    return (x // m) * m


def _center_crop(arr: np.ndarray, ch: int, cw: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top, left = (h - ch) // 2, (w - cw) // 2
    return arr[top:top + ch, left:left + cw]


class Run:
    """The frame pairs of ``root``.

    ``is_pair``: every ``*_img1.*`` with an ``*_img2.*`` sibling; otherwise
    consecutive frames (f[i], f[i+1]). ``start_at`` and ``n_images`` slice
    the file list first. A sample is ``((img1, img2), path of img1)``.
    """

    def __init__(self, root: str, is_pair: bool = False, n_images: int = -1, start_at: int = 0):
        files = _sorted_images(root)
        if is_pair:
            firsts = [f for f in files if os.path.splitext(f)[0].endswith("_img1")]
            firsts = firsts[start_at:] if n_images < 0 else firsts[start_at:start_at + n_images]
            self.pairs = []
            for f1 in firsts:
                base, ext = os.path.splitext(f1)
                f2 = base.rsplit("_", 1)[0] + "_img2" + ext
                if os.path.isfile(f2):
                    self.pairs.append((f1, f2))
        else:
            files = files[start_at:] if n_images < 0 else files[start_at:start_at + n_images]
            self.pairs = list(zip(files[:-1], files[1:]))

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int):
        f1, f2 = self.pairs[idx]
        return (_load_image(f1), _load_image(f2)), f1


class InferenceRun(Run):
    """``Run`` with every frame centre-cropped to a multiple of ``crop_multiple``; with
    ``use_stereo`` the pairs of ``root/left`` and ``root/right`` together, as
    ``((l1, l2, r1, r2), (left name, right name))``."""

    def __init__(self, root: str, pair: bool = False, use_stereo: bool = False,
                 n_images: int = -1, start_at: int = 0, crop_multiple: int = 64):
        self.use_stereo = use_stereo
        self.crop_multiple = crop_multiple
        if use_stereo:
            self.left = Run(os.path.join(root, "left"), pair, n_images, start_at)
            self.right = Run(os.path.join(root, "right"), pair, n_images, start_at)
            if len(self.left) != len(self.right):
                raise ValueError(f"left/right frame counts differ: {len(self.left)} vs {len(self.right)}")
            self.pairs = self.left.pairs
        else:
            super().__init__(root, pair, n_images, start_at)

    def _crop(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        return _center_crop(img, _floor_multiple(h, self.crop_multiple),
                            _floor_multiple(w, self.crop_multiple))

    def __getitem__(self, idx: int):
        if self.use_stereo:
            (l1, l2), lname = self.left[idx]
            (r1, r2), rname = self.right[idx]
            return tuple(self._crop(x) for x in (l1, l2, r1, r2)), (lname, rname)
        (i1, i2), name = super().__getitem__(idx)
        return (self._crop(i1), self._crop(i2)), name


class InferenceEval:
    """Pairs with their ground truth: ``<base>_flow.flo`` beside ``<base>_img1.*`` (or
    ``<base>.flo``) in ``flow_root`` (default ``root``). A sample is
    ``((img1, img2), flow, name)``."""

    def __init__(self, root: str, flow_root: Optional[str] = None, pair: bool = True):
        self.inner = Run(root, is_pair=pair)
        flow_root = flow_root or root
        self.flows = []
        for f1, _ in self.inner.pairs:
            base = os.path.splitext(os.path.basename(f1))[0].rsplit("_", 1)[0]
            cand = os.path.join(flow_root, base + "_flow.flo")
            if not os.path.isfile(cand):
                cand = os.path.join(flow_root, base + ".flo")
            self.flows.append(cand)

    def __len__(self) -> int:
        return len(self.inner)

    def __getitem__(self, idx: int):
        (i1, i2), name = self.inner[idx]
        return (i1, i2), read_flow(self.flows[idx]), name


class PIVData:
    """Training triplets listed by the ``<mode>*.json`` manifests under ``root``.

    A manifest lists ``.flo`` paths (relative to ``root``); ``<base>_flow.flo``
    pairs with ``<base>_img1.X`` and ``<base>_img2.X``. ``render_size`` is the
    first frame's size floored to a multiple of ``crop_multiple``. A sample is
    ``((img1, img2), flow)``.
    """

    def __init__(self, root: str, mode: str = "train", crop_multiple: int = 64):
        manifests = sorted(glob(os.path.join(root, f"{mode}*.json")))
        if not manifests:
            raise FileNotFoundError(f"no {mode}*.json manifest under {root}")
        flo_list: List[str] = []
        for m in manifests:
            with open(m) as f:
                entries = json.load(f)
            flo_list += [e if os.path.isabs(e) else os.path.join(root, e) for e in entries]
        self.samples = []
        for flo in flo_list:
            base = flo.replace("_flow.flo", "")
            img1 = img2 = None
            for ext in IMG_EXTENSIONS:
                if os.path.isfile(base + "_img1" + ext):
                    img1, img2 = base + "_img1" + ext, base + "_img2" + ext
                    break
            if img1 and os.path.isfile(flo):
                self.samples.append((img1, img2, flo))
        if not self.samples:
            raise FileNotFoundError(f"manifests under {root} resolved to no samples")
        h, w = _load_image(self.samples[0][0]).shape[:2]
        self.render_size = (_floor_multiple(h, crop_multiple), _floor_multiple(w, crop_multiple))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        i1, i2, flo = self.samples[idx]
        return (_load_image(i1), _load_image(i2)), read_flow(flo)


class PIVH5:
    """HDF5 store whose ``train``/``val`` groups hold ``data1``, ``data2`` and ``label``
    (frames in [0, 1] or [0, 255], grey or rgb); needs ``h5py``."""

    def __init__(self, root: str, mode: str = "train", crop_multiple: int = 64):
        import h5py

        self.path = root
        self.mode = mode
        self._h5 = h5py.File(root, "r")
        grp = self._h5[mode]
        self.data1, self.data2, self.label = grp["data1"], grp["data2"], grp["label"]
        h, w = self.data1.shape[1:3]
        self.render_size = (_floor_multiple(h, crop_multiple), _floor_multiple(w, crop_multiple))

    def __len__(self) -> int:
        return self.data1.shape[0]

    def __getitem__(self, idx: int):
        i1 = np.asarray(self.data1[idx], np.float32)
        i2 = np.asarray(self.data2[idx], np.float32)
        if i1.max() > 1.5:
            i1, i2 = i1 / 255.0, i2 / 255.0
        if i1.ndim == 2:
            i1 = np.repeat(i1[..., None], 3, -1)
            i2 = np.repeat(i2[..., None], 3, -1)
        return (i1, i2), np.asarray(self.label[idx], np.float32)

    def close(self) -> None:
        self._h5.close()


class PIVLMDB:
    """LMDB store of pickled ``(img1 png bytes, img2 png bytes, flow)`` under zero-padded
    integer keys, with ``__len__``/``__shape__`` entries; needs ``lmdb``. Unpickles what
    the store holds: open only stores this program wrote."""

    def __init__(self, root: str, mode: str = "train", crop_multiple: int = 64):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("PIVLMDB requires the 'lmdb' package (not installed)") from e
        self.env = lmdb.open(root, subdir=os.path.isdir(root), readonly=True,
                             lock=False, readahead=False, meminit=False)
        with self.env.begin(write=False) as txn:
            self.length = pickle.loads(txn.get(b"__len__"))
            self.shape = pickle.loads(txn.get(b"__shape__"))
        h, w = self.shape[:2]
        self.render_size = (_floor_multiple(h, crop_multiple), _floor_multiple(w, crop_multiple))

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int):
        from PIL import Image

        with self.env.begin(write=False) as txn:
            b1, b2, flow = pickle.loads(txn.get(f"{idx:08d}".encode()))
        i1 = np.asarray(Image.open(io.BytesIO(b1)).convert("RGB"), np.float32) / 255.0
        i2 = np.asarray(Image.open(io.BytesIO(b2)).convert("RGB"), np.float32) / 255.0
        return (i1, i2), np.asarray(flow, np.float32)


def get_transform(args=None, crop_size: Tuple[int, int] = (256, 256), mode: str = "train"):
    """The default augmentation (``data/transforms.py:Pipeline``): in training translate 16 %,
    scale 0.95-1.45, both flips and the photometric ranges; otherwise both flips only.
    ``args.crop_size``, where given, sets the crop."""
    from piv_liteflownet_tpu_torch.data import transforms as T

    if args is not None:
        crop_size = tuple(getattr(args, "crop_size", crop_size))
    if mode == "train":
        return T.Pipeline(
            crop_size=crop_size, translate=16, scale_range=(0.95, 1.45), hflip=True, vflip=True,
            photometric=T.Photometric(noise_std_range=(0.0, 0.04), contrast_range=(-0.8, 0.4),
                                      brightness_sigma=0.2, color_range=(0.5, 2.0),
                                      gamma_range=(0.7, 1.5)))
    return T.Pipeline(crop_size=crop_size, hflip=True, vflip=True, photometric=None)
