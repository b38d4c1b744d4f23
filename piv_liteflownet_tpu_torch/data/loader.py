"""Host to device feeding: threaded decode, then prefetch onto the device (port of
``piv_liteflownet_tpu/data/loader.py``).

``BatchLoader`` decodes and collates numpy batches on a thread pool, in the
JAX package's order (the shuffle stream is ``np.random.default_rng(seed +
epoch)``). ``native_loader_for`` and ``native_train_loader_for`` give the C++
loaders of ``data/native.py`` (``libpivio``) where their decoders apply; they
yield the same batches as host tensors in a ring of pinned slots.
``PrefetchLoader`` moves each batch onto the device ahead of its use: on a
card it copies from pinned host memory on a side CUDA stream, and the
consumer's stream waits on that copy before it reads the batch.
Augmentation is not done here: it runs on the device inside the train step
(``data/transforms.py``).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from piv_liteflownet_tpu_torch.utils.profiling import LOADER_STAGE, LOADER_WAIT, span


#: formats the C++ decoders handle (PNG 8/16-bit colour types 0/2/3/4/6 not interlaced,
#: baseline TIFF uncompressed or PackBits, PNM); a dataset with any other goes to the
#: Python loader's PIL threads.
NATIVE_EXTS = {"pgm", "ppm", "png", "tif", "tiff"}


def _native_threads(num_workers: int) -> int:
    return max(2, min(num_workers, 4 * (os.cpu_count() or 1)))


def _native_exts() -> set:
    from piv_liteflownet_tpu_torch.data import native

    return NATIVE_EXTS if native.has_png() else NATIVE_EXTS - {"png"}


def native_loader_for(dataset, batch_size: int, num_workers: int = 4):
    """``libpivio``'s loader over an inference dataset, or None where its decoders do not
    apply.

    A ``data.pivseq.PivseqRun`` gets a ``NativeSeqLoader``; a ``Run`` whose files are all in
    ``NATIVE_EXTS`` (PNG only where the library was built with zlib) and whose first frame
    decodes gets a ``NativeBatchLoader`` at that frame's size; other datasets get None and
    take the Python loader. Raises if the library cannot be built or loaded.
    """
    from piv_liteflownet_tpu_torch.data import native

    native.load()
    if hasattr(dataset, "index_pairs") and hasattr(dataset, "reader"):
        return native.NativeSeqLoader(dataset, batch_size, threads=max(2, num_workers))
    pairs = getattr(dataset, "pairs", None)
    if not pairs:
        return None
    exts = {p.rsplit(".", 1)[-1].lower() for pair in pairs for p in pair}
    if not exts <= _native_exts():
        return None
    try:
        probe = native.image_read(pairs[0][0])
    except IOError:
        return None
    return native.NativeBatchLoader(pairs, batch_size, probe.shape[0], probe.shape[1],
                                    threads=_native_threads(num_workers))


def native_train_loader_for(dataset, batch_size: int, num_workers: int = 4, shuffle: bool = True,
                            seed: int = 0, drop_last: bool = True, rank: int = 0, ranks: int = 1):
    """``libpivio``'s training loader over a dataset of ``(img1, img2, flo)`` path triplets
    (``PIVData.samples``), or None where it does not apply (no such triplets, or a frame
    format the decoders reject). Its batches and their order equal ``BatchLoader``'s with the
    same ``shuffle``, ``seed``, ``drop_last``, ``rank`` and ``ranks``. Raises if the library
    cannot be built or loaded."""
    from piv_liteflownet_tpu_torch.data import native

    native.load()
    samples = getattr(dataset, "samples", None)
    if not samples or len(samples[0]) != 3:
        return None
    exts = {p.rsplit(".", 1)[-1].lower() for s in samples for p in s[:2]}
    if not exts <= _native_exts():
        return None
    try:
        probe = native.image_read(samples[0][0])
        fprobe = native.flo_read(samples[0][2])
    except IOError:
        return None
    return native.NativeTrainLoader(
        samples, batch_size, probe.shape[0], probe.shape[1], fprobe.shape[0], fprobe.shape[1],
        threads=_native_threads(num_workers), shuffle=shuffle, seed=seed, drop_last=drop_last,
        rank=rank, ranks=ranks)


def _collate(samples):
    """Stack ``((img1, img2), meta)`` samples into ``((im1, im2), metas)``; array metas (flows)
    are stacked too, others (names) kept as a list. Frames of different sizes in one batch
    raise ``ValueError`` naming the batch's first frames."""
    firsts, seconds, metas = [], [], []
    for (i1, i2), meta in samples:
        firsts.append(i1)
        seconds.append(i2)
        metas.append(meta)
    sizes = [a.shape for a in firsts + seconds]
    if len(set(sizes)) > 1:
        names = "" if isinstance(metas[0], np.ndarray) else f" of {', '.join(map(str, metas))}"
        raise ValueError(f"frames of different sizes in one batch{names}: {sizes}; the frames of a "
                         "batch must share one size")
    im1 = np.stack(firsts)
    im2 = np.stack(seconds)
    if isinstance(metas[0], np.ndarray):
        metas = np.stack(metas)
    return (im1, im2), metas


class BatchLoader:
    """Batches of a dataset, decoded by ``num_workers`` threads (0: in the calling thread).

    Yields ``((im1[B,H,W,3], im2[B,H,W,3]), metas)``; the last partial batch is
    yielded unless ``drop_last``. With ``ranks`` above 1 (data-parallel training) it
    forms the global batches of ``batch_size`` as one loader would and yields rank
    ``rank``'s rows of each, ``parallel/mesh.py:split_rows``, decoding only those; a
    batch that does not split evenly raises ``ValueError``, as JAX's ``device_put``
    onto a ``data`` sharding does.
    """

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 4,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False,
                 rank: int = 0, ranks: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.rank, self.ranks = rank, ranks
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle stream to a global epoch number, so that a resumed run sees the
        order an unbroken run would."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        bs = self.batch_size
        batches = [idx[i:i + bs] for i in range(0, len(idx), bs)]
        if self.drop_last and batches and len(batches[-1]) < bs:
            batches.pop()
        if self.ranks > 1:
            batches = _rank_rows(batches, self.rank, self.ranks)
        if self.num_workers <= 0:
            for batch_idx in batches:
                yield _collate([self.dataset[int(i)] for i in batch_idx])
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []  # two batches of futures in flight
            bi = 0
            while bi < len(batches) or pending:
                while bi < len(batches) and len(pending) < 2:
                    pending.append([pool.submit(self.dataset.__getitem__, int(i)) for i in batches[bi]])
                    bi += 1
                futs = pending.pop(0)
                yield _collate([f.result() for f in futs])


def _rank_rows(batches: list, rank: int, ranks: int) -> list:
    """Rank ``rank``'s rows of each global batch, in order; raises before the epoch's first batch
    if one of them does not split evenly."""
    from piv_liteflownet_tpu_torch.parallel.mesh import split_rows

    return [batch[split_rows(len(batch), ranks, rank)] for batch in batches]


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    return fn(tree)


class PrefetchLoader:
    """Move the arrays of each batch of ``inner`` onto ``device`` ``prefetch`` batches ahead,
    on a background thread; other entries (names) stay on the host.

    Entries are numpy arrays or CPU tensors. On a CUDA device an array is copied into pinned
    host memory, a tensor that is pinned already (a native loader's slot) is not, and each is
    copied from there without blocking on a side stream; the yielded tensors are safe to use
    on the stream that is current where the loop consumes them: that stream waits on the
    copy, and each tensor is recorded on it for the caching allocator. A pinned copy made
    here lives until the consumer has taken the next batch, and PyTorch's pinned-memory
    allocator does not reuse a block before the copies that read it have finished. Memory
    the source owns is its own to guard: ``fence``, where given, receives the CUDA event
    recorded after each batch's copies, before the next batch is drawn from ``inner`` (a
    native loader's ``fence``). On the CPU the entries are copied into new tensors.
    """

    def __init__(self, inner: Iterable, device, prefetch: int = 2, fence: Optional[Callable] = None):
        self.inner = inner
        self.device = torch.device(device)
        self.prefetch = prefetch
        self.fence = fence

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        err: list = []
        sentinel = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def move(x, pinned):
            if isinstance(x, np.ndarray) and x.dtype != object:
                x = torch.from_numpy(np.ascontiguousarray(x))
            elif not isinstance(x, torch.Tensor):
                return x
            if not cuda:
                return x.clone()
            if not x.is_pinned():
                x = x.pin_memory()
                pinned.append(x)
            return x.to(self.device, non_blocking=True)

        def producer():
            try:
                for batch in self.inner:
                    pinned: list = []
                    with span(LOADER_STAGE):
                        if cuda:
                            with torch.cuda.stream(stream):
                                out = _map(lambda x: move(x, pinned), batch)
                                done = torch.cuda.Event()
                                done.record(stream)
                            if self.fence is not None:
                                self.fence(done)
                        else:
                            out, done = _map(lambda x: move(x, pinned), batch), None
                    if not put((out, done, pinned)):
                        return
            except Exception as e:  # raised again in the consumer
                err.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                with span(LOADER_WAIT):
                    item = q.get()
                    if item is sentinel:
                        break
                    out, done, _pinned = item
                    if cuda:
                        current = torch.cuda.current_stream(self.device)
                        current.wait_event(done)
                        _map(lambda t: t.record_stream(current) if isinstance(t, torch.Tensor) and t.is_cuda
                             else None, out)
                yield out
        finally:
            stop.set()
            thread.join()
        if err:
            raise err[0]
