"""Which torch.distributed collectives take CUDA tensors, per backend, on this machine.

Run on a machine with a CUDA card::

    python tests/gloo_cuda_probe.py

Each case runs in two fresh processes (gloo, both ranks on ``cuda:0``) or one
(nccl, world size 1) with its own time limit, so a collective that crashes or
hangs fails only its own case. A case passes when every rank's result equals
the one computed on the host. Prints one line a case and, last, a JSON object
``{"torch": ..., "gloo_cuda": {name: "ok" | reason}, "nccl_1": {...}}``.
``parallel/mesh.py:GLOO_CUDA_STAGED`` lists the collectives that gloo does not
take on the card; the exchange helpers stage those through pinned host memory.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import sys
import tempfile
import traceback

CASES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "send_recv",
         "batch_isend_irecv", "barrier")
TIMEOUT_S = 60


def _case(name: str, rank: int, world: int, dev):
    import torch
    import torch.distributed as dist

    x = torch.arange(6, dtype=torch.float32, device=dev) + 10 * rank
    if name == "all_reduce":
        dist.all_reduce(x)
        want = sum(torch.arange(6, dtype=torch.float32) + 10 * r for r in range(world))
        return torch.equal(x.cpu(), want)
    if name == "broadcast":
        dist.broadcast(x, 0)
        return torch.equal(x.cpu(), torch.arange(6, dtype=torch.float32))
    if name == "all_gather":
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return all(torch.equal(o.cpu(), torch.arange(6, dtype=torch.float32) + 10 * r)
                   for r, o in enumerate(out))
    if name == "all_gather_into_tensor":
        out = torch.empty(world * 6, device=dev)
        dist.all_gather_into_tensor(out, x)
        return torch.equal(out.cpu(), torch.cat([torch.arange(6, dtype=torch.float32) + 10 * r
                                                 for r in range(world)]))
    if name in ("send_recv", "batch_isend_irecv"):
        if world == 1:
            return True
        peer = 1 - rank
        got = torch.full_like(x, -1.0)
        if name == "send_recv":
            if rank == 0:
                dist.send(x, peer)
                dist.recv(got, peer)
            else:
                dist.recv(got, peer)
                dist.send(x, peer)
        else:
            for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                             dist.P2POp(dist.irecv, got, peer)]):
                w.wait()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return torch.equal(got.cpu(), torch.arange(6, dtype=torch.float32) + 10 * peer)
    if name == "barrier":
        dist.barrier()
        return True
    raise ValueError(name)


def _child(name: str, backend: str, rank: int, world: int, init: str, q) -> None:
    try:
        import torch
        import torch.distributed as dist

        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **kw)
        ok = _case(name, rank, world, dev)
        dist.destroy_process_group()
        q.put((rank, "ok" if ok else "wrong values"))
    except Exception as e:  # reported, not raised: the parent prints every case
        q.put((rank, f"{type(e).__name__}: {str(e).splitlines()[0][:160] if str(e) else ''}"))
        traceback.print_exc()


def run_case(name: str, backend: str, world: int) -> str:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rdv')}"
        procs = [ctx.Process(target=_child, args=(name, backend, r, world, init, q)) for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(TIMEOUT_S)
        results = {}
        while not q.empty():
            r, msg = q.get()
            results[r] = msg
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
                results.setdefault(procs.index(p), f"timed out after {TIMEOUT_S} s")
            elif p.exitcode != 0 and procs.index(p) not in results:
                results[procs.index(p)] = f"exit code {p.exitcode}"
    msgs = sorted(set(results.values())) or ["no result"]
    return "ok" if msgs == ["ok"] and len(results) == world else "; ".join(msgs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    report = {"torch": torch.__version__, "cuda": torch.version.cuda, "gloo_cuda": {}, "nccl_1": {}}
    for name in CASES:
        report["gloo_cuda"][name] = run_case(name, "gloo", 2)
        print(f"gloo, 2 ranks on cuda:0, {name}: {report['gloo_cuda'][name]}", flush=True)
    for name in CASES:
        report["nccl_1"][name] = run_case(name, "nccl", 1)
        print(f"nccl, world size 1, {name}: {report['nccl_1'][name]}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
