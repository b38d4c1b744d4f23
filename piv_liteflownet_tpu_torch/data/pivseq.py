""".pivseq: a packed raw-frame container for decode-free inference ingest (port of
``piv_liteflownet_tpu/data/pivseq.py``; a container either package writes, the
other reads, byte for byte the same).

Frames are stored raw (u8/u16/f32, a grayscale source as one channel) and
mmap'd and dequantized straight into batches, with no inflate or filter pass;
the original file names are kept in a trailing name table, so the ``Run``
pairing rules (``*_img1``/``*_img2`` or consecutive frames) and the output
names (``<base>_out.flo``) apply unchanged.

Layout (little-endian): magic ``PIVSEQ01`` | u32 h, w, c, dtype (0=u8, 1=u16,
2=f32) | u64 n_frames | u64 names_offset | raw HWC frames | NUL-separated
names. Decoded values: float32 RGB in [0, 1], bit-equal to the PIL and native
image paths for u8/u16 sources (the same ``v / maxval``).

Pack a directory: ``python -m piv_liteflownet_tpu_torch.data.pivseq DIR [OUT]``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"PIVSEQ01"
_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.float32}
_DTYPE_IDS = {"uint8": 0, "uint16": 1, "float32": 2}


def _load_raw(path: str) -> np.ndarray:
    """Read an image file preserving its integer depth (HWC, 1 or 3 ch)."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("I;16", "I;16B", "I"):
            arr = np.asarray(im, dtype=np.uint16)
        elif im.mode in ("L", "RGB"):
            arr = np.asarray(im)
        elif im.mode in ("LA", "RGBA", "P"):
            arr = np.asarray(im.convert("RGB"))
        else:
            arr = np.asarray(im.convert("RGB"))
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def write_pivseq(
    image_paths: Sequence[str],
    out_path: str,
    dtype: Optional[str] = None,
) -> dict:
    """Pack ``image_paths`` (all one size) into ``out_path``.

    ``dtype`` None auto-selects: uint16 if any source is 16-bit, else uint8
    (f32 sources are not produced by the supported readers). Mono sources
    (single-channel, or RGB with identical channels everywhere) are stored
    single-channel. Returns the header summary dict.
    """
    if not image_paths:
        raise ValueError("no images to pack")
    frames = []
    any16 = False
    mono = True
    h = w = None
    for p in image_paths:
        arr = _load_raw(p)
        if h is None:
            h, w = arr.shape[0], arr.shape[1]
        elif (arr.shape[0], arr.shape[1]) != (h, w):
            raise ValueError(
                f"{p}: size {arr.shape[:2]} != first frame {(h, w)}")
        any16 = any16 or arr.dtype == np.uint16
        if arr.shape[2] == 3:
            mono = mono and bool(
                (arr[..., 0] == arr[..., 1]).all()
                and (arr[..., 1] == arr[..., 2]).all())
        frames.append(arr)
    if dtype is None:
        dtype = "uint16" if any16 else "uint8"
    did = _DTYPE_IDS[dtype]
    np_dtype = _DTYPES[did]
    c = 1 if mono else 3

    names = [os.path.basename(p).encode() for p in image_paths]
    n = len(frames)
    frame_bytes = h * w * c * np.dtype(np_dtype).itemsize
    names_off = 40 + frame_bytes * n

    with open(out_path, "wb") as f:
        f.write(MAGIC)
        f.write(np.asarray([h, w, c, did], np.uint32).tobytes())
        f.write(np.asarray([n, names_off], np.uint64).tobytes())
        for arr in frames:
            a = arr[..., :1] if (c == 1 and arr.shape[2] == 3) else arr
            if a.shape[2] != c:
                # mono source into an RGB container: replicate
                a = np.repeat(a, 3, axis=2)
            if a.dtype != np_dtype:
                if np_dtype == np.float32:
                    maxv = 65535.0 if a.dtype == np.uint16 else 255.0
                    a = a.astype(np.float32) / maxv
                elif np_dtype == np.uint16 and a.dtype == np.uint8:
                    a = a.astype(np.uint16) * 257  # 0..255 -> 0..65535 exact
                else:
                    raise ValueError(
                        f"cannot pack {a.dtype} frames as {dtype}")
            f.write(np.ascontiguousarray(a).tobytes())
        f.write(b"\x00".join(names) + b"\x00")
    return {"h": h, "w": w, "c": c, "dtype": dtype, "n_frames": n}


def pack_directory(root: str, out_path: Optional[str] = None,
                   dtype: Optional[str] = None) -> str:
    """Pack every image in ``root`` (sorted, the ``Run`` scan order) into
    ``<root>.pivseq`` (or ``out_path``)."""
    from piv_liteflownet_tpu_torch.data.datasets import _sorted_images

    files = _sorted_images(root)
    if not files:
        raise ValueError(f"no images under {root}")
    out = out_path or (root.rstrip("/") + ".pivseq")
    write_pivseq(files, out, dtype=dtype)
    return out


class PivseqReader:
    """Header and name table, and frames decoded from a numpy mmap (the Python loader's
    path; ``data/native.py:NativeSeqLoader`` is the C one)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(40)
        if head[:8] != MAGIC:
            raise ValueError(f"{path}: not a .pivseq file")
        h, w, c, did = np.frombuffer(head[8:24], np.uint32)
        n, names_off = np.frombuffer(head[24:40], np.uint64)
        self.h, self.w, self.c, self.dtype_id = int(h), int(w), int(c), int(did)
        self.n_frames = int(n)
        if self.dtype_id not in _DTYPES or self.c not in (1, 3):
            raise ValueError(f"{path}: bad header (c={self.c}, dtype={did})")
        self.np_dtype = _DTYPES[self.dtype_id]
        with open(path, "rb") as f:
            f.seek(int(names_off))
            blob = f.read()
        self.names: List[str] = [
            s.decode() for s in blob.split(b"\x00") if s][: self.n_frames]
        if len(self.names) != self.n_frames:
            raise ValueError(f"{path}: name table has {len(self.names)} "
                             f"entries for {self.n_frames} frames")
        self._mm = np.memmap(path, self.np_dtype, mode="r", offset=40,
                             shape=(self.n_frames, self.h, self.w, self.c))

    def frame(self, i: int) -> np.ndarray:
        """Frame ``i`` as float32 RGB HWC in [0,1] (the loader contract)."""
        a = np.asarray(self._mm[i])
        if self.dtype_id == 0:
            a = a.astype(np.float32) / 255.0
        elif self.dtype_id == 1:
            a = a.astype(np.float32) / 65535.0
        else:
            a = a.astype(np.float32)
        if self.c == 1:
            a = np.repeat(a, 3, axis=2)
        return a


class PivseqRun:
    """The ``Run`` dataset of one packed file: the same pairing rules on the stored names,
    the same ``((img1, img2), name)`` samples, ``name`` the original file name (so
    ``flowname_modifier`` names the outputs as for the directory)."""

    def __init__(self, path: str, is_pair: bool = False, n_images: int = -1,
                 start_at: int = 0):
        self.reader = PivseqReader(path)
        self.path = path
        names = self.reader.names
        by_name = {n: i for i, n in enumerate(names)}
        if is_pair:
            firsts = [n for n in names
                      if os.path.splitext(n)[0].endswith("_img1")]
            firsts = (firsts[start_at:] if n_images < 0
                      else firsts[start_at: start_at + n_images])
            self.index_pairs: List[Tuple[int, int]] = []
            self.pairs: List[Tuple[str, str]] = []
            for n1 in firsts:
                base, ext = os.path.splitext(n1)
                n2 = base.rsplit("_", 1)[0] + "_img2" + ext
                if n2 in by_name:
                    self.index_pairs.append((by_name[n1], by_name[n2]))
                    self.pairs.append((n1, n2))
        else:
            idx = list(range(len(names)))
            idx = (idx[start_at:] if n_images < 0
                   else idx[start_at: start_at + n_images])
            self.index_pairs = list(zip(idx[:-1], idx[1:]))
            self.pairs = [(names[i], names[j]) for i, j in self.index_pairs]

    def __len__(self) -> int:
        return len(self.index_pairs)

    def __getitem__(self, idx: int):
        i, j = self.index_pairs[idx]
        return ((self.reader.frame(i), self.reader.frame(j)),
                self.pairs[idx][0])


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Pack an image directory into a .pivseq raw container "
                    "for decode-free inference ingest")
    p.add_argument("input", help="image directory (scanned sorted, like run.py)")
    p.add_argument("output", nargs="?", default=None,
                   help="output path (default <input>.pivseq)")
    p.add_argument("--dtype", choices=sorted(_DTYPE_IDS), default=None,
                   help="stored sample type (default: source depth)")
    args = p.parse_args(argv)
    out = pack_directory(args.input, args.output, dtype=args.dtype)
    info = PivseqReader(out)
    print(f"packed {info.n_frames} frames {info.h}x{info.w}x{info.c} "
          f"{info.np_dtype.__name__} -> {out} "
          f"({os.path.getsize(out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
