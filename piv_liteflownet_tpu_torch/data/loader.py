"""Host to device feeding: threaded decode, then prefetch onto the device (port of
``piv_liteflownet_tpu/data/loader.py``).

``BatchLoader`` decodes and collates numpy batches on a thread pool, in the
JAX package's order (the shuffle stream is ``np.random.default_rng(seed +
epoch)``). ``PrefetchLoader`` moves each batch onto the device ahead of its
use: on a card it copies from pinned host memory on a side CUDA stream, and
the consumer's stream waits on that copy before it reads the batch.
Augmentation is not done here: it runs on the device inside the train step
(``data/transforms.py``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch


def native_loader_for(dataset, batch_size: int, num_workers: int = 4):
    """The C++ batch loader of the native-I/O slice."""
    raise NotImplementedError("native I/O (data/native.py, libpivio) is not ported yet; see ROADMAP.md")


def native_train_loader_for(dataset, batch_size: int, num_workers: int = 4, shuffle: bool = True,
                            seed: int = 0, drop_last: bool = True):
    """The C++ training loader of the native-I/O slice."""
    raise NotImplementedError("native I/O (data/native.py, libpivio) is not ported yet; see ROADMAP.md")


def _collate(samples):
    """Stack ``((img1, img2), meta)`` samples into ``((im1, im2), metas)``; array metas (flows)
    are stacked too, others (names) kept as a list."""
    firsts, seconds, metas = [], [], []
    for (i1, i2), meta in samples:
        firsts.append(i1)
        seconds.append(i2)
        metas.append(meta)
    im1 = np.stack(firsts)
    im2 = np.stack(seconds)
    if isinstance(metas[0], np.ndarray):
        metas = np.stack(metas)
    return (im1, im2), metas


class BatchLoader:
    """Batches of a dataset, decoded by ``num_workers`` threads (0: in the calling thread).

    Yields ``((im1[B,H,W,3], im2[B,H,W,3]), metas)``; the last partial batch is
    yielded unless ``drop_last``.
    """

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 4,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
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


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    return fn(tree)


class PrefetchLoader:
    """Move the numpy arrays of each batch of ``inner`` onto ``device`` ``prefetch`` batches
    ahead, on a background thread; other entries (names) stay on the host.

    On a CUDA device each array is copied into pinned host memory and from there, without
    blocking, on a side stream; the yielded tensors are safe to use on the stream that is
    current where the loop consumes them: that stream waits on the copy, and each tensor is
    recorded on it for the caching allocator. The pinned copy lives until the consumer has
    taken the next batch, and PyTorch's pinned-memory allocator does not reuse a block
    before the copies that read it have finished. On the CPU the arrays are copied into
    tensors, nothing pinned.
    """

    def __init__(self, inner: Iterable, device, prefetch: int = 2):
        self.inner = inner
        self.device = torch.device(device)
        self.prefetch = prefetch

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
            if not isinstance(x, np.ndarray) or x.dtype == object:
                return x
            t = torch.from_numpy(np.ascontiguousarray(x))
            if not cuda:
                return t.clone()
            t = t.pin_memory()
            pinned.append(t)
            return t.to(self.device, non_blocking=True)

        def producer():
            try:
                for batch in self.inner:
                    pinned: list = []
                    if cuda:
                        with torch.cuda.stream(stream):
                            out = _map(lambda x: move(x, pinned), batch)
                            done = torch.cuda.Event()
                            done.record(stream)
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
