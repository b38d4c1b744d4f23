"""Dataset packers: ``.flo`` manifests to HDF5 and LMDB training stores (port of
``piv_liteflownet_tpu/data/write_data.py``).

- ``samples_from_flo_list`` / ``samples_from_manifest``: the ``(img1, img2,
  flo)`` triplets of ``*_flow.flo`` paths, each beside its ``_img1``/``_img2``;
- ``write_hdf5``: ``train``/``val`` groups holding ``data1``, ``data2`` (uint8
  RGB) and ``label`` (float32 flow), which ``datasets.PIVH5`` reads;
- ``write_lmdb``: pickled ``(img1 bytes, img2 bytes, flow)`` values with
  ``__len__``/``__shape__`` entries, which ``datasets.PIVLMDB`` reads; needs
  the ``lmdb`` package, imported inside it.
"""

from __future__ import annotations

import json
import os
import pickle
from glob import glob
from typing import List, Sequence, Tuple

import numpy as np

from piv_liteflownet_tpu_torch.utils.flow_io import read_flow

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".ppm")


def samples_from_flo_list(flo_list: Sequence[str]) -> List[Tuple[str, str, str]]:
    """Resolve (img1, img2, flo) triplets from ``*_flow.flo`` paths."""
    out = []
    for flo in flo_list:
        base = flo.replace("_flow.flo", "")
        for ext in IMG_EXTENSIONS:
            if os.path.isfile(base + "_img1" + ext):
                out.append((base + "_img1" + ext, base + "_img2" + ext, flo))
                break
    return out


def samples_from_manifest(root: str, manifest: str) -> List[Tuple[str, str, str]]:
    with open(manifest) as f:
        entries = json.load(f)
    flo_list = [e if os.path.isabs(e) else os.path.join(root, e) for e in entries]
    return samples_from_flo_list(flo_list)


def _load_sample(img1: str, img2: str, flo: str):
    from PIL import Image

    i1 = np.asarray(Image.open(img1).convert("RGB"), np.uint8)
    i2 = np.asarray(Image.open(img2).convert("RGB"), np.uint8)
    return i1, i2, read_flow(flo)


def write_hdf5(root: str, outfile: str, modes: Sequence[str] = ("train", "val")) -> None:
    """Pack manifests under ``root`` into an HDF5 store."""
    import h5py

    with h5py.File(outfile, "w") as h5:
        for mode in modes:
            manifests = sorted(glob(os.path.join(root, f"{mode}*.json")))
            samples: List[Tuple[str, str, str]] = []
            for m in manifests:
                samples += samples_from_manifest(root, m)
            if not samples:
                continue
            i1, i2, flow = _load_sample(*samples[0])
            grp = h5.create_group(mode)
            d1 = grp.create_dataset("data1", (len(samples),) + i1.shape, dtype=np.uint8)
            d2 = grp.create_dataset("data2", (len(samples),) + i2.shape, dtype=np.uint8)
            lb = grp.create_dataset("label", (len(samples),) + flow.shape, dtype=np.float32)
            for idx, s in enumerate(samples):
                a, b, f = _load_sample(*s)
                d1[idx], d2[idx], lb[idx] = a, b, f
    print(f"wrote {outfile}")


def write_lmdb(root: str, outfile: str, mode: str = "train",
               map_size: int = 1 << 32, commit_every: int = 128) -> None:
    """Pack a manifest into an LMDB store (requires the optional lmdb pkg)."""
    try:
        import lmdb
    except ImportError as e:
        raise ImportError("write_lmdb requires the 'lmdb' package (not installed)") from e

    manifests = sorted(glob(os.path.join(root, f"{mode}*.json")))
    samples: List[Tuple[str, str, str]] = []
    for m in manifests:
        samples += samples_from_manifest(root, m)
    assert samples, f"no {mode} samples under {root}"

    env = lmdb.open(outfile, subdir=False, map_size=map_size)
    txn = env.begin(write=True)
    shape = None
    for idx, (img1, img2, flo) in enumerate(samples):
        with open(img1, "rb") as f:
            b1 = f.read()
        with open(img2, "rb") as f:
            b2 = f.read()
        flow = read_flow(flo)
        shape = flow.shape[:2]
        txn.put(f"{idx:08d}".encode(), pickle.dumps((b1, b2, flow)))
        if (idx + 1) % commit_every == 0:
            txn.commit()
            txn = env.begin(write=True)
    txn.put(b"__len__", pickle.dumps(len(samples)))
    txn.put(b"__shape__", pickle.dumps(shape))
    txn.commit()
    env.close()
    print(f"wrote {outfile} ({len(samples)} samples)")
