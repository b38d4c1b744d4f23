"""The device mesh of the port: one process per device in a ``torch.distributed`` process group.

Port of ``piv_liteflownet_tpu/parallel/mesh.py``. JAX is single-controller: one
process holds a ``Mesh`` of devices and XLA inserts the collectives. PyTorch is
SPMD: each device has a process of its own (a rank), and the ranks meet in a
process group. A :class:`Mesh` is that group as one rank sees it: the axis name
(``"data"`` or ``"spatial"``), the number of ranks, this rank's index and
device, and the backend.

Backends: NCCL on CUDA devices (the default there), gloo on the CPU. A caller
may ask for gloo on CUDA devices, as two ranks that share one card must (NCCL
refuses two ranks on one device). Gloo does not take CUDA tensors in every
collective: :data:`GLOO_CUDA_STAGED` names those that it does not take on
the card (``tests/gloo_cuda_probe.py`` finds them), and the helpers here stage
each of those through pinned host memory, in the gloo-on-CUDA branch alone. The
compute stays on the card, and NCCL never takes that branch.

:func:`spawn` runs a function in ``n`` ranks, each a process started with
``spawn``, which meet through a file in a new temporary directory: never a
fixed port, since several test processes run side by side. Every rank has a
time limit, so a hang fails instead of waiting.

The counterparts of JAX's shardings: :func:`shard_rows` (``data_sharding``, a
rank's rows of a global batch) and :func:`gather_rows` (``replicated``, the
rows of every rank on every rank).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

#: The collectives that gloo does not take CUDA tensors in: send and receive ("p2p"), whose TCP
#: transport reads the device pointer as host memory ("writev: Bad address"); all_reduce,
#: broadcast, all_gather and barrier take them (``tests/gloo_cuda_probe.py`` on an H100, torch
#: 2.11). Only these are staged through pinned host memory.
GLOO_CUDA_STAGED = frozenset({"p2p"})
#: Seconds a rank may take in all, and a collective may wait, before :func:`spawn` fails.
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass
class Traffic:
    """What this rank moved through the mesh since the last :meth:`reset`.

    ``halo``: one record a row exchange (``ops/halo_warp.py:extend_rows``): ``(label, rows
    above, rows below, bytes of a row, bytes sent, bytes received)``, the rows being those the
    call asked for (no more than exist up to the frame's edges). ``gathers``: one record a
    gather of whole maps, ``(label, bytes received)``.
    """

    halo: List[tuple] = dataclasses.field(default_factory=list)
    gathers: List[tuple] = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        self.halo.clear()
        self.gathers.clear()

    @property
    def halo_sent(self) -> int:
        return sum(r[4] for r in self.halo)

    @property
    def halo_received(self) -> int:
        return sum(r[5] for r in self.halo)


@dataclasses.dataclass(eq=False)
class Mesh:
    """The process group as this rank sees it (see the module docstring)."""

    axis: str
    size: int
    rank: int
    device: torch.device
    backend: str
    group: Any = None  # None: the default group
    traffic: Traffic = dataclasses.field(default_factory=Traffic)
    owns_group: bool = False  # make_mesh made the group: close() destroys it
    rendezvous_dir: Optional[str] = None  # the group's rendezvous file's directory, where it owns it

    def staged(self, collective: str) -> bool:
        """Whether ``collective`` goes through pinned host memory here (gloo on a CUDA device)."""
        return self.backend == "gloo" and self.device.type == "cuda" and collective in GLOO_CUDA_STAGED

    def close(self) -> None:
        """Destroy the process group if :func:`make_mesh` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False
        if self.rendezvous_dir:
            shutil.rmtree(self.rendezvous_dir, ignore_errors=True)
            self.rendezvous_dir = None


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_group(backend: str, init_method: str, world: int, rank: int, device: torch.device,
                timeout_s: float) -> None:
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = ("data",),
              devices: Optional[Sequence] = None, backend: Optional[str] = None) -> Mesh:
    """The mesh of this rank over the first ``n_devices`` devices, one rank each.

    Inside a process group (a rank of :func:`spawn`) it describes that group, whose size must be
    ``n_devices`` where that is given. Outside one, ``n_devices`` must be None or 1: it makes a
    group of one rank (NCCL at a world size of 1 on a card), which :meth:`Mesh.close` destroys.
    ``devices``: each rank's device (default: ``cuda:<rank>`` where CUDA is available, else
    the CPU). ``backend``: default NCCL on CUDA, gloo on the CPU. Only the first of ``axes``
    names the mesh: the port's meshes have one axis.
    """
    if len(axes) != 1:
        raise ValueError(f"the port's meshes have one axis, got {tuple(axes)}")
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"make_mesh({n_devices}) inside a process group of {world} ranks")
    else:
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}) outside a process group: use spawn() for "
                             "more than one rank")
        world, rank = 1, 0
    if devices is not None:
        device = torch.device(devices[rank])
    elif torch.cuda.is_available():
        device = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        device = torch.device("cpu")
    backend = backend or (dist.get_backend() if dist.is_initialized() else default_backend(device))
    tmp = None
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="piv_mesh_")
        try:
            _init_group(backend, "file://" + os.path.join(tmp, "rendezvous"), 1, 0, device, DEFAULT_TIMEOUT_S)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    return Mesh(axes[0], world, rank, device, backend, owns_group=tmp is not None, rendezvous_dir=tmp)


def devices_to_use(n: int, cpu: bool, what: str = "devices") -> int:
    """The number of ranks a CLI runs for ``n`` requested: with ``cpu``, ``n`` (``-1`` is 1);
    else ``n`` clamped to the CUDA devices present (``-1`` is all of them). Prints the count."""
    if cpu:
        used = 1 if n < 0 else max(1, n)
        print(f"{used} CPU rank(s) for {what}", flush=True)
        return used
    count = torch.cuda.device_count()
    used = count if n < 0 else min(max(1, n), count)
    if 0 < n and used < n:
        print(f"WARNING: only {count} CUDA device(s) (requested {n})", flush=True)
    print(f"{used} CUDA device(s) for {what}", flush=True)
    return used


# -- collectives, staged through pinned host memory where gloo does not take the card's tensors --

def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 2-byte float as bytes (bit for bit): gloo's gathers take neither bfloat16 nor int16."""
    return t.view(torch.uint8) if t.dtype in (torch.bfloat16, torch.float16) else t


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks (``op`` "sum" or "max"), in place; returns ``t``."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if mesh.staged("all_reduce"):
        h = _host(t)
        dist.all_reduce(h, red, group=mesh.group)
        return t.copy_(h)
    dist.all_reduce(t, red, group=mesh.group)
    return t


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank, in place; returns ``t``."""
    if mesh.staged("broadcast"):
        h = _host(t)
        dist.broadcast(_bits(h), src, group=mesh.group)
        return t.copy_(h)
    dist.broadcast(_bits(t), src, group=mesh.group)
    return t


def all_gather(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in rank order."""
    src = _host(t) if mesh.staged("all_gather") else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather([_bits(p) for p in parts], _bits(src), group=mesh.group)
    return torch.cat(parts, dim).to(t.device)


def exchange(mesh: Mesh, sends: Sequence[tuple], recvs: Sequence[tuple]) -> None:
    """Point-to-point: send each ``(peer, tensor)`` of ``sends`` and fill each ``(peer, tensor)``
    of ``recvs``, all posted at once (``batch_isend_irecv``). Every rank must post the sends
    that match its peers' receives, in the same order for a pair of ranks."""
    if not sends and not recvs:
        return
    staged = mesh.staged("p2p")
    out = [(peer, _host(t) if staged else t.contiguous()) for peer, t in sends]
    into = [(peer, t, torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if staged else t)
            for peer, t in recvs]
    ops = ([dist.P2POp(dist.isend, _bits(t), peer, group=mesh.group) for peer, t in out]
           + [dist.P2POp(dist.irecv, _bits(buf), peer, group=mesh.group) for peer, _, buf in into])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for _, t, buf in into:
        if buf is not t:
            t.copy_(buf)


# -- the batch's rows --------------------------------------------------------------------------

def split_rows(b: int, size: int, rank: int) -> slice:
    """Rows of a global batch of ``b`` that rank ``rank`` of ``size`` holds; raises where ``b``
    does not split evenly, as JAX's ``device_put`` onto a ``data`` sharding does."""
    if b % size:
        raise ValueError(f"a batch of {b} does not split over {size} ranks")
    n = b // size
    return slice(rank * n, (rank + 1) * n)


def shard_rows(mesh: Mesh, x):
    """This rank's rows of the global batch ``x`` (numpy array or tensor, batch first)."""
    return x[split_rows(x.shape[0], mesh.size, mesh.rank)]


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's rows ``x`` (equal counts), on every rank."""
    return all_gather(mesh, x, 0)


# -- spawn -------------------------------------------------------------------------------------

def _rank_main(fn, rank: int, n: int, init: str, backend: Optional[str], devices, axes, threads: Optional[int],
               timeout_s: float, q, args) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        device = torch.device(devices[rank]) if devices is not None else (
            torch.device("cuda", rank % torch.cuda.device_count()) if torch.cuda.is_available()
            else torch.device("cpu"))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        _init_group(backend or default_backend(device), init, n, rank, device, timeout_s)
        try:
            mesh = make_mesh(n, axes, devices=[device] * n, backend=backend or default_backend(device))
            value = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        q.put((rank, True, value))
    except BaseException:  # the parent raises it with this rank's traceback
        q.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, n: int, *args, backend: Optional[str] = None, devices: Optional[Sequence] = None,
          axes: Sequence[str] = ("data",), timeout_s: float = DEFAULT_TIMEOUT_S,
          threads: Optional[int] = None) -> list:
    """Run ``fn(mesh, *args)`` in ``n`` new processes, one rank each; returns their results in
    rank order (each must pickle).

    ``fn`` must be importable by name (a module-level function): each process imports its
    module anew. ``devices``: each rank's device (default ``cuda:<rank>`` where CUDA is
    available, else the CPU); ``["cuda:0", "cuda:0"]`` with ``backend="gloo"`` puts two ranks
    on one card. ``threads``: torch's CPU threads in each rank (default: the parent's count
    shared out). A rank that raises, or a run longer than ``timeout_s``, ends every rank and
    raises here.
    """
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    threads = threads or max(1, torch.get_num_threads() // n)
    tmp = tempfile.mkdtemp(prefix="piv_spawn_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, init, backend, devices, tuple(axes), threads,
                                                  timeout_s, q, args), daemon=True)
             for r in range(n)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn({getattr(fn, '__name__', fn)}, {n}): ranks "
                                   f"{sorted(set(range(n)) - set(results))} did not finish in {timeout_s} s")
            try:
                rank, ok, value = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results and p.exitcode is not None]
                if dead:
                    time.sleep(0.5)  # a result put just before the exit may still be in the pipe
                    if q.empty():
                        raise RuntimeError(f"spawn: rank(s) {dead} exited with code(s) "
                                           f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} of {n} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        q.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(n)]
