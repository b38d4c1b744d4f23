"""A measurement campaign streamed through ``estimate`` as the program's ``run`` streams a
directory: a ``PrefetchLoader`` stages each batch on the card from pinned host memory on a
side stream, two batches are in flight, and each flow is copied into pinned host memory
behind an event, which the loop waits on only when a third batch has been handed over. No
flow file is written.

Traffic keys: ``size``, ``pool`` (pairs rendered on the card from the seed, then held pinned
on the host), ``batch``, ``families`` and ``amp_px`` (:mod:`h100_bench.traffic`),
``warm_batches`` (set-up). Check keys: ``batches`` (how many of the window's batches are
compared), ``among`` (the window batches they are drawn from, ``[first, last)``),
``ref_block`` (pairs a reference call takes). A window that ends before a drawn batch
compares its last batch in that batch's place.

End to end: ``pairs_per_s``, the pairs whose flow reached host memory in the window over
its seconds; ``batch_p90_ms``, the 90th percentile over the window's batches of the time
from handing a batch to ``estimate`` to the host seeing its flow copied.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from h100_bench import traffic, work
from h100_bench.reference import model as ref_model
from h100_bench.reference import precision, weights


def span(name: str):
    return torch.profiler.record_function("h100_bench." + name)


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.tr = cell.traffic
        self.device = torch.device(cell.device)
        self.cuda = self.device.type == "cuda"
        self.batch = int(self.tr["batch"])
        self.stats = {}
        self.kept = []  # (pool batch index, flows [B,H,W,2] float32 on the host)
        self.latencies = []

    # -- set-up ----------------------------------------------------------------------------
    def setup(self) -> None:
        from piv_liteflownet_tpu_torch import inference
        from piv_liteflownet_tpu_torch.data.loader import PrefetchLoader
        from piv_liteflownet_tpu_torch.models.liteflownet import LiteFlowNet, ModelConfig
        from piv_liteflownet_tpu_torch.utils.checkpoint import load_params_npz

        m = self.cell.config["model"]
        cfg = ModelConfig(version=m["version"], starting_scale=m["starting_scale"],
                          lowest_level=m["lowest_level"], rgb_mean=tuple(m["rgb_mean"]),
                          conv_impl=self.cell.config["conv_impl"])
        model = LiteFlowNet(cfg)
        model.load_state_dict(load_params_npz(cfg, str(self.cell.weights)), strict=True)
        model = model.to(self.device).eval()
        if self.cell.config["precision"] == "bfloat16":
            model = model.to(torch.bfloat16)
        self.model, self.estimate = model, inference.estimate

        frames = traffic.pool(self.tr, self.cell.seed, self.device)
        self.pool = {k: self._host(frames[k]) for k in ("img1", "img2")}
        del frames
        n = int(self.tr["pool"])
        if n % self.batch:
            raise ValueError(f"a pool of {n} pairs does not split into batches of {self.batch}")
        self.n_slots = n // self.batch
        g = traffic.rng(self.cell.seed, 2)
        lo, hi = self.cell.checks["among"]
        self.sampled = set(int(i) for i in g.choice(np.arange(lo, hi), int(self.cell.checks["batches"]), replace=False))

        def batches():
            while True:
                for k in g.permutation(self.n_slots):
                    k = int(k)
                    rows = slice(k * self.batch, (k + 1) * self.batch)
                    yield (self.pool["img1"][rows], self.pool["img2"][rows]), k

        self.loader = PrefetchLoader(batches(), self.device)
        self.it = iter(self.loader)
        self._loop(count=int(self.tr["warm_batches"]))
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)
        out.copy_(t)
        return out

    # -- the loop ------------------------------------------------------------------------
    def _loop(self, count=None, until=None, window=False) -> dict:
        s = dict(calls=0, loader_wait_s=0.0, host_s=0.0)
        inflight = deque()

        def drain(item):
            host, copied, t_hand, k, index = item
            with span("drain"):
                if copied is not None:
                    copied.synchronize()
            if window:
                self.latencies.append(time.perf_counter() - t_hand)
                if index in self.sampled:
                    self.kept.append((k, host.clone()))
                self.last = (k, host)

        while (count is None or s["calls"] < count) and (until is None or time.perf_counter() < until):
            t = time.perf_counter()
            with span("loader_wait"):
                (im1, im2), k = next(self.it)
            t_hand = time.perf_counter()
            s["loader_wait_s"] += t_hand - t
            with span("estimate"):
                flows = self.estimate(self.model, im1, im2, tensor=True).float()
                if self.cuda:
                    host = torch.empty(flows.shape, dtype=torch.float32, pin_memory=True)
                    host.copy_(flows, non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record()
                else:
                    host, copied = flows.cpu(), None
            s["host_s"] += time.perf_counter() - t_hand
            inflight.append((host, copied, t_hand, k, s["calls"]))
            s["calls"] += 1
            if len(inflight) > 2:
                drain(inflight.popleft())
        while inflight:
            drain(inflight.popleft())
        return s

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        s = self._loop(until=t0 + seconds, window=True)
        s["window_s"] = time.perf_counter() - t0
        if len(self.kept) < int(self.cell.checks["batches"]):  # a window too short for its sample
            self.kept.append(self.last)
        s["items"] = s["calls"] * self.batch
        s["attempted"], s["failed"] = s["items"], 0
        self.stats = s

    def end_to_end(self) -> dict:
        return {"pairs_per_s": self.stats["items"] / self.stats["window_s"],
                "batch_p90_ms": 1e3 * float(np.percentile(self.latencies, 90))}

    def work(self) -> dict:
        m = self.cell.config["model"]
        h, w = self.tr["size"]
        ah, aw = -(-h // 32) * 32, -(-w // 32) * 32
        chain = self.cell.config["conv_impl"] == "chain"
        return {"flops_per_call": work.conv_flops(m, self.batch, ah, aw),
                "ops_per_call": work.port_ops(m, self.batch, ah, aw, chain=chain)}

    def release(self) -> None:
        self.it.close()
        del self.it, self.loader, self.model
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------------------
    def reference_flows(self, k: int, quant=None) -> torch.Tensor:
        """The reference's flows of pool batch ``k`` (float32 on the host)."""
        if not hasattr(self, "_params"):
            self._params = weights.load_npz(str(self.cell.weights), self.device)
        net = ref_model.Net(self._params, self.cell.config["model"], quant)
        rows = range(k * self.batch, (k + 1) * self.batch)
        block = int(self.cell.checks["ref_block"])
        out = []
        before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad():
                for i in range(0, self.batch, block):
                    r = list(rows)[i:i + block]
                    im1 = self.pool["img1"][r].to(self.device)
                    im2 = self.pool["img2"][r].to(self.device)
                    out.append(ref_model.estimate(net, im1, im2).cpu())
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
        return torch.cat(out)

    def check(self, flows=None) -> dict:
        """The compared numbers: the mean end-point distance (px) of the window's flows from the
        reference's over every compared pixel, and the largest over the compared pairs of a
        pair's mean. ``flows`` (the control) puts other flows in the window's place."""
        if not self.kept:
            return {name: float("nan") for name in self.cell.checks["limits"]}
        pairs = []
        for k, got in (self.kept if flows is None else flows):
            epe = torch.linalg.vector_norm(got.float() - self.reference_flows(k), dim=-1)
            pairs += [float(e) for e in epe.double().mean(dim=(1, 2))]
        mean = sum(pairs) / len(pairs)
        return {"epe_mean_px": mean if mean == mean else float("inf"),
                "pair_epe_max_px": max(pairs) if all(p == p for p in pairs) else float("inf")}

    def calibration(self, control: bool) -> dict:
        """The readings a limit is set from: the program's numbers and, with ``control``, the
        control's: the reference in float8 e4m3 in the window's place."""
        out = {"program": self.check()}
        if control:
            out["control"] = self.check([(k, self.reference_flows(k, precision.fp8)) for k, _ in self.kept])
        return out
