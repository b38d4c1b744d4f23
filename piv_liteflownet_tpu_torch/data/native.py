"""ctypes bindings of ``libpivio``, the port's native I/O (port of
``piv_liteflownet_tpu/data/native.py``).

The C++ side (``data/_native/pivio.cpp``, the port's own copy) decodes
``.flo`` files, PGM/PPM/PNG/TIFF images and packed ``.pivseq`` frames, and
runs a pthread pool that keeps decoded float32 NHWC batches ahead of the
consumer. ctypes releases the GIL for every call into it.

The library is built at first use with ``g++`` into ``build/pivio/`` under
the repository root, named by the hash of its source and flags, through a
temporary file renamed into place (several test processes may build it at
once). Where zlib's header is missing it is built with ``-DPIVIO_NO_PNG``:
``has_png()`` is then False and PNG files are left to the Python loader.
Nothing here falls back quietly: a failed build or load raises with the
compiler's message.

The batch loaders write each batch into a ring of host tensors, pinned where
a CUDA device is present, and yield views of it: ``PrefetchLoader`` copies
them to the card without pinning them again. A slot is written again
``ring`` batches later; before that the loader waits on the event that
``fence`` gave for the batch last taken from the slot (the copy that reads
it). A consumer that keeps a batch longer copies it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "_native" / "pivio.cpp"
CXX = "g++"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pivio"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
RING = 4  # host slots a loader cycles through


@dataclass(frozen=True)
class BuildResult:
    path: Path
    rebuilt: bool
    seconds: float
    png: bool  # the PNG decoder is compiled in (zlib's header was found)
    compiler: str  # the first line of ``g++ --version``


def zlib_header_found() -> bool:
    """Whether the compiler finds ``<zlib.h>`` (a preprocessor run, milliseconds)."""
    proc = subprocess.run([CXX, "-E", "-x", "c++", "-", "-o", os.devnull], input="#include <zlib.h>\n",
                          capture_output=True, text=True)
    return proc.returncode == 0


def build() -> BuildResult:
    """Compile ``pivio.cpp`` unless a build of the same source and flags exists; raises with
    the compiler's output when it fails."""
    try:
        version = subprocess.run([CXX, "--version"], capture_output=True, text=True).stdout.splitlines()[0]
    except (OSError, IndexError) as e:
        raise RuntimeError(f"libpivio: the C++ compiler {CXX!r} was not found") from e
    png = zlib_header_found()
    flags = CXX_FLAGS + (() if png else ("-DPIVIO_NO_PNG",))
    digest = hashlib.sha256(" ".join(flags).encode() + b"\0" + SRC.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"libpivio-{digest}.so"
    if path.is_file():
        return BuildResult(path, False, 0.0, png, version)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix="libpivio-", suffix=".tmp")
    os.close(fd)
    cmd = [CXX, *flags, str(SRC), *(["-lz"] if png else []), "-o", tmp]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"libpivio: {' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return BuildResult(path, True, time.perf_counter() - t0, png, version)


_lib = None
_lock = threading.Lock()

_C, _I, _L, _P = ctypes.c_char_p, ctypes.c_int, ctypes.c_long, ctypes.c_void_p
_F = ctypes.POINTER(ctypes.c_float)
_IP, _LP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)
_CP = ctypes.POINTER(ctypes.c_char_p)
#: C signature of every entry point: name -> (restype, argtypes).
SIGNATURES = {
    "pivio_has_png": (_I, ()),
    "pivio_flo_read": (_I, (_C, _F, _I, _IP, _IP, _I)),
    "pivio_flo_write": (_I, (_C, _F, _I, _I, _I)),
    "pivio_image_read": (_I, (_C, _F, _I, _IP, _IP)),
    "pivio_loader_create": (_P, (_CP, _CP, _L, _I, _I, _I, _I)),
    "pivio_loader_create_flow": (_P, (_CP, _CP, _CP, _L, _I, _I, _I, _I, _I, _I)),
    "pivio_loader_next_flow": (_I, (_P, _F, _F)),
    "pivio_loader_batches": (_L, (_P,)),
    "pivio_loader_next": (_I, (_P, _F)),
    "pivio_loader_error": (_I, (_P, _LP, _IP, _IP)),
    "pivio_loader_destroy": (None, (_P,)),
    "pivio_seq_info": (_I, (_C, _IP, _IP, _IP, _IP, _LP, _LP, _LP)),
    "pivio_seq_read_frame": (_I, (_C, _L, _F, _L)),
    "pivio_seqloader_create": (_P, (_C, _LP, _LP, _L, _I, _I)),
}


def load() -> ctypes.CDLL:
    """The library, built on first use, with every signature set. Raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def has_png() -> bool:
    """Whether the loaded library decodes PNG (False when built without zlib's header)."""
    return bool(load().pivio_has_png())


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(_F)


def _tptr(t: torch.Tensor):
    return ctypes.cast(t.data_ptr(), _F)


def flo_read(path: str, bands: int = 2) -> np.ndarray:
    """A ``.flo`` file as float32 ``[H,W,bands]`` (``utils.flow_io.read_flow``'s values)."""
    lib = load()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.pivio_flo_read(path.encode(), None, 0, ctypes.byref(h), ctypes.byref(w), bands)
    if rc != 0:
        raise IOError(f"flo_read({path}) failed rc={rc}")
    out = np.empty((h.value, w.value, bands), np.float32)
    rc = lib.pivio_flo_read(path.encode(), _fptr(out), out.size, ctypes.byref(h), ctypes.byref(w), bands)
    if rc != 0:
        raise IOError(f"flo_read({path}) failed rc={rc}")
    return out


def flo_write(path: str, flow: np.ndarray) -> None:
    """Write ``[H,W,bands]`` as a ``.flo`` file, byte-equal to ``utils.flow_io.write_flow``'s."""
    flow = np.ascontiguousarray(flow, np.float32)
    h, w, bands = flow.shape
    rc = load().pivio_flo_write(path.encode(), _fptr(flow), h, w, bands)
    if rc != 0:
        raise IOError(f"flo_write({path}) failed rc={rc}")


def image_read(path: str) -> np.ndarray:
    """A PGM/PPM/PNG/TIFF image as float32 RGB ``[H,W,3]`` in [0, 1] (PIL's ``convert("RGB")``
    values over 255, or over 65535 at 16 bits)."""
    lib = load()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.pivio_image_read(path.encode(), None, 0, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"image_read({path}) failed rc={rc}")
    out = np.empty((h.value, w.value, 3), np.float32)
    rc = lib.pivio_image_read(path.encode(), _fptr(out), out.size, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"image_read({path}) failed rc={rc}")
    return out


def seq_read_frame(path: str, i: int, h: int, w: int) -> np.ndarray:
    """Frame ``i`` of a ``.pivseq`` file as float32 RGB ``[H,W,3]`` in [0, 1]."""
    out = np.empty((h, w, 3), np.float32)
    rc = load().pivio_seq_read_frame(path.encode(), i, _fptr(out), out.size)
    if rc != 0:
        raise IOError(f"seq_read_frame({path}, {i}) failed rc={rc}")
    return out


class SlotRing:
    """``n`` sets of host tensors of ``shapes`` (pinned where CUDA is present) handed out in
    turn.

    ``take`` returns the next slot, after waiting on the event fenced on it when it was last
    handed out; ``fence`` sets that event for the slot handed out last.
    """

    def __init__(self, shapes: Sequence[Tuple[int, ...]], n: int = RING):
        pin = torch.cuda.is_available()
        self.slots = [[torch.empty(s, dtype=torch.float32, pin_memory=pin) for s in shapes] for _ in range(n)]
        self.fences: list = [None] * n
        self.count = 0

    def take(self) -> list:
        k = self.count % len(self.slots)
        self.count += 1
        if self.fences[k] is not None:
            self.fences[k].synchronize()
            self.fences[k] = None
        return self.slots[k]

    def fence(self, event) -> None:
        self.fences[(self.count - 1) % len(self.slots)] = event


def _loader_error(lib, handle, paths: Sequence[Sequence[str]], size: Tuple[int, int],
                  flow_size: Tuple[int, int] = (0, 0)) -> IOError:
    """The error of a batch that the C loader failed (``pivio_loader_next`` gave -2), naming
    the file at fault; ``paths`` are the loader's samples, each ``(img1, img2[, flo])``."""
    sample, h, w = ctypes.c_long(), ctypes.c_int(), ctypes.c_int()
    why = lib.pivio_loader_error(handle, ctypes.byref(sample), ctypes.byref(h), ctypes.byref(w))
    files = paths[sample.value]
    if why in (1, 2):
        return IOError(f"libpivio: cannot decode {files[why - 1]}")
    if why in (3, 4):
        return IOError(f"libpivio: {files[why - 3]} is {h.value}x{w.value}; the frames of this loader are "
                       f"{size[0]}x{size[1]}, the first frame's size")
    if why == 5:
        return IOError(f"libpivio: cannot read {files[2]}")
    return IOError(f"libpivio: {files[2]} is {h.value}x{w.value}; the flows of this loader are "
                   f"{flow_size[0]}x{flow_size[1]}")


class _PairLoader:
    """What the inference loaders share: a C loader handle, the ring and the yields
    ``((im1 [B,H,W,3], im2 [B,H,W,3]), names of the first frames)`` (a short last batch
    trimmed). A pair that does not decode, or whose frames are not ``h`` x ``w``, raises
    ``IOError`` naming its file."""

    def __init__(self, lib, handle, pairs: Sequence[Tuple[str, str]], batch: int, h: int, w: int):
        self._lib = lib
        self._handle = handle
        self.pairs = list(pairs)
        self.names = [p[0] for p in self.pairs]
        self.batch = batch
        self.h, self.w = h, w
        self.n_batches = lib.pivio_loader_batches(handle)
        self.ring = SlotRing([(2, batch, h, w, 3)])

    def __len__(self):
        return int(self.n_batches)

    def fence(self, event) -> None:
        """Let the slot of the batch yielded last be written again only after ``event``."""
        self.ring.fence(event)

    def __iter__(self):
        if not self._handle:
            raise RuntimeError("the loader is closed")
        for bi in range(self.n_batches):
            (buf,) = self.ring.take()
            valid = self._lib.pivio_loader_next(self._handle, _tptr(buf))
            if valid == -2:
                raise _loader_error(self._lib, self._handle, self.pairs, (self.h, self.w))
            if valid < 0:
                break
            yield (buf[0, :valid], buf[1, :valid]), self.names[bi * self.batch:bi * self.batch + valid]

    def close(self):
        if self._handle:
            self._lib.pivio_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeBatchLoader(_PairLoader):
    """The pairs of PGM/PPM/PNG/TIFF files, ``height`` x ``width`` each, decoded by ``threads``
    C threads; yields ``((im1, im2), names of the first frames)`` in order, one pass."""

    def __init__(self, pairs: Sequence[Tuple[str, str]], batch_size: int, height: int, width: int,
                 threads: int = 4):
        lib = load()
        pairs = list(pairs)
        n = len(pairs)
        self._p1 = (ctypes.c_char_p * n)(*[p[0].encode() for p in pairs])
        self._p2 = (ctypes.c_char_p * n)(*[p[1].encode() for p in pairs])
        handle = lib.pivio_loader_create(self._p1, self._p2, n, batch_size, height, width, threads)
        super().__init__(lib, handle, pairs, batch_size, height, width)


class NativeSeqLoader(_PairLoader):
    """The pairs of a ``data.pivseq.PivseqRun``, dequantized from the mmap'd container by
    ``threads`` C threads; yields ``((im1, im2), original names of the first frames)``."""

    def __init__(self, dataset, batch_size: int, threads: int = 4):
        lib = load()
        n = len(dataset.index_pairs)
        i1 = (ctypes.c_long * n)(*[p[0] for p in dataset.index_pairs])
        i2 = (ctypes.c_long * n)(*[p[1] for p in dataset.index_pairs])
        handle = lib.pivio_seqloader_create(dataset.path.encode(), i1, i2, n, batch_size, threads)
        if not handle:
            raise IOError(f"pivio_seqloader_create({dataset.path}) failed")
        super().__init__(lib, handle, dataset.pairs, batch_size, dataset.reader.h, dataset.reader.w)


class NativeTrainLoader:
    """Training triplets ``(img1, img2, .flo)`` decoded by ``threads`` C threads; yields
    ``((im1 [B,H,W,3], im2 [B,H,W,3]), flow [B,FH,FW,2])`` like ``BatchLoader`` over a
    ``PIVData``. The order of an epoch is drawn from ``np.random.default_rng(seed + epoch)``
    (``set_epoch`` pins it), and ``drop_last`` drops the short last batch; the C loader is
    made anew each epoch over the permuted paths. With ``ranks`` above 1 it yields rank
    ``rank``'s rows of each global batch and decodes only those, as ``BatchLoader`` does. A
    sample that does not decode, or whose frames or flow are not of the given sizes, raises
    ``IOError`` naming its file."""

    def __init__(self, triplets: Sequence[Tuple[str, str, str]], batch_size: int, height: int, width: int,
                 fh: int, fw: int, threads: int = 4, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, rank: int = 0, ranks: int = 1):
        load()
        self.rank, self.ranks = rank, ranks
        self.triplets = list(triplets)
        self.batch = batch_size
        self.h, self.w, self.fh, self.fw = height, width, fh, fw
        self.threads = threads
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        rows = batch_size // ranks if ranks > 1 else batch_size  # a rank's rows of a full batch
        self.ring = SlotRing([(2, rows, height, width, 3), (rows, fh, fw, 2)])

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def fence(self, event) -> None:
        """Let the slot of the batch yielded last be written again only after ``event``."""
        self.ring.fence(event)

    def __len__(self):
        n = len(self.triplets)
        return n // self.batch if self.drop_last else -(-n // self.batch)

    def __iter__(self):
        lib = load()
        order = np.arange(len(self.triplets))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        if self.drop_last:
            order = order[:len(order) // self.batch * self.batch]
        batch = self.batch
        if self.ranks > 1:
            from piv_liteflownet_tpu_torch.parallel.mesh import split_rows

            order = np.concatenate([order[i:i + batch][split_rows(len(order[i:i + batch]), self.ranks, self.rank)]
                                    for i in range(0, len(order), batch)] or [order])
            batch //= self.ranks
        trips = [self.triplets[i] for i in order]
        n = len(trips)
        p1, p2, pf = ((ctypes.c_char_p * n)(*[t[j].encode() for t in trips]) for j in range(3))
        handle = lib.pivio_loader_create_flow(p1, p2, pf, n, batch, self.h, self.w, self.fh, self.fw,
                                              self.threads)
        try:
            for _ in range(lib.pivio_loader_batches(handle)):
                imgs, flow = self.ring.take()
                valid = lib.pivio_loader_next_flow(handle, _tptr(imgs), _tptr(flow))
                if valid == -2:
                    raise _loader_error(lib, handle, trips, (self.h, self.w), (self.fh, self.fw))
                if valid < 0:
                    break
                yield (imgs[0, :valid], imgs[1, :valid]), flow[:valid]
        finally:
            lib.pivio_loader_destroy(handle)
