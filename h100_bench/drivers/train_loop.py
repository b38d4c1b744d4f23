"""Fine-tuning as the program's trainer runs it: the step of ``make_train_step`` with the
default augmentation inside it, Adam over the four parameter groups at the schedule's first
rates, batches staged on the card by a ``PrefetchLoader``, each step's augmentation seeded as
the trainer seeds it, and the losses read back every ``readback`` steps.

Traffic keys: ``size`` and ``pool`` (pairs with their flows, rendered from the seed and held
on the host; each pass over the pool takes its rows in a new order drawn from the seed),
``batch``, ``crop``, ``families``, ``amp_px``, ``readback``, ``warm_steps`` (set-up; the
first three are the checked ones). The configuration's ``optim`` gives the rates and decays.

Set-up builds the model, the optimizer and the step once and drives them through their
first steps with the loop the window runs; the check replays the first three in the
reference from the weights file: each step's loss, each leaf's first gradient as Adam holds
it after one step, and each leaf's change after three.

End to end: ``samples_per_s``, the samples of the steps completed in the window over its
seconds.
"""

from __future__ import annotations

import statistics
import time

import torch

from h100_bench import traffic, work
from h100_bench.reference import train as ref_train
from h100_bench.reference import weights

CHECKED_STEPS = 3


def span(name: str):
    return torch.profiler.record_function("h100_bench." + name)


def step_seed(seed: int, epoch: int, batch_idx: int) -> int:
    """A step's augmentation seed, as the trainer derives it from its run's seed."""
    return seed * 100003 + epoch * 1009 + batch_idx


def worst(values) -> float:
    """The largest of ``values``; infinity where one is not a number."""
    out = 0.0
    for v in values:
        out = float("inf") if v != v else max(out, v)
    return out


def compare(got: dict, ref: dict) -> dict:
    """Each step's loss against the reference's, relative; each leaf's first-gradient norm, and
    its change's norm after three steps, against the reference's, over the larger of that
    leaf's and the median leaf's reference norm: the worst case of each, and the median leaf's
    gradient gap (the worst leaf's swings with the float32 summation order of the largest
    sums, the first conv's wgrad over the whole frames). Leaves whose reference gradient is
    under a thousandth of the median leaf's, which Adam moves by round-off alone, are left
    out of the change."""
    med_g = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][k] for k in moved)
    grad = [abs(got["grad"][k] - g) / max(g, med_g) for k, g in ref["grad"].items()]
    return {"loss_gap": worst(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "grad_gap": worst(grad),
            "grad_gap_median": statistics.median(grad) if all(v == v for v in grad) else float("inf"),
            "change_gap": worst(abs(got["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
                                for k in moved)}


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.tr = cell.traffic
        self.device = torch.device(cell.device)
        self.cuda = self.device.type == "cuda"
        self.batch = int(self.tr["batch"])
        self.run_seed = abs(int(cell.seed)) % (2 ** 31)
        self.stats = {}
        self.first = []  # (epoch, batch index) of the checked steps

    def _rows(self, epoch: int):
        return traffic.rng(self.cell.seed, 100 + epoch).permutation(int(self.tr["pool"]))

    def setup(self) -> None:
        from piv_liteflownet_tpu_torch.data.datasets import get_transform
        from piv_liteflownet_tpu_torch.data.loader import PrefetchLoader
        from piv_liteflownet_tpu_torch.models.liteflownet import LiteFlowNet, ModelConfig
        from piv_liteflownet_tpu_torch.parallel import train_step
        from piv_liteflownet_tpu_torch.training import loss, optim
        from piv_liteflownet_tpu_torch.utils.checkpoint import load_params_npz

        m, o = self.cell.config["model"], self.cell.config["optim"]
        cfg = ModelConfig(version=m["version"], starting_scale=m["starting_scale"],
                          lowest_level=m["lowest_level"], rgb_mean=tuple(m["rgb_mean"]),
                          conv_impl=self.cell.config["conv_impl"])
        model = LiteFlowNet(cfg)
        model.load_state_dict(load_params_npz(cfg, str(self.cell.weights)), strict=True)
        model = model.to(self.device)
        opt = optim.make_optimizer(model, cfg.lowest_level, optimizer="Adam", lr=o["lr_hi"], low_lr=o["lr_lo"],
                                   weight_decay=o["weight_decay"], bias_decay=o["bias_decay"],
                                   betas=tuple(o["betas"]), eps=o["eps"])
        loss_obj = loss.piv_loss(version=1) if cfg.version == 1 else loss.v2_multiscale()
        pipeline = get_transform(crop_size=tuple(self.tr["crop"]), mode="train")
        self.step = train_step.make_train_step(cfg, loss_obj, opt, pipeline=pipeline)
        self.state = train_step.TrainState(model, opt)
        self.params = [p for g in opt.param_groups for p in g["params"]]
        self.names = {id(p): n for n, p in model.named_parameters()}

        data = traffic.pool(self.tr, self.cell.seed, self.device)
        self.pool = {k: v.cpu() for k, v in data.items()}
        del data
        n = int(self.tr["pool"])

        def batches():
            epoch = 0
            while True:
                epoch += 1
                order = self._rows(epoch)
                for bi in range(n // self.batch):
                    rows = torch.from_numpy(order[bi * self.batch:(bi + 1) * self.batch])
                    yield ((self.pool["img1"][rows], self.pool["img2"][rows]), self.pool["flow"][rows]), (epoch, bi)

        self.loader = PrefetchLoader(batches(), self.device)
        self.it = iter(self.loader)

        p0 = [p.detach().clone() for p in self.params]
        b1 = float(o["betas"][0])
        self.readings = {}

        def after(i, metrics):
            if i == 0:
                st = self.state.optimizer.state
                self.readings["grad"] = {self.names[id(p)]: float(torch.linalg.vector_norm(st[p]["exp_avg"]) / (1 - b1))
                                         if p in st and "exp_avg" in st[p] else 0.0 for p in self.params}
            if i == CHECKED_STEPS - 1:
                self.readings["change"] = {self.names[id(p)]: float(torch.linalg.vector_norm(p.detach() - q))
                                           for p, q in zip(self.params, p0)}
            if i < CHECKED_STEPS:
                self.readings.setdefault("losses", []).append(float(metrics["loss"]))

        self._loop(count=max(int(self.tr["warm_steps"]), CHECKED_STEPS), after=after)
        del p0
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _loop(self, count=None, until=None, after=None) -> dict:
        s = dict(calls=0, loader_wait_s=0.0, host_s=0.0, failed=0)
        pending = []
        every = int(self.tr["readback"])

        def flush():
            with span("readback"):
                for loss in pending:
                    value = float(loss)
                    s["failed"] += int(value != value)
            pending.clear()

        while (count is None or s["calls"] < count) and (until is None or time.perf_counter() < until):
            t = time.perf_counter()
            with span("loader_wait"):
                ((im1, im2), target), (epoch, bi) = next(self.it)
            t_call = time.perf_counter()
            s["loader_wait_s"] += t_call - t
            with span("step"):
                self.state, metrics = self.step(self.state, im1, im2, target, step_seed(self.run_seed, epoch, bi))
            s["host_s"] += time.perf_counter() - t_call
            if after is not None:
                if s["calls"] < CHECKED_STEPS:
                    self.first.append((epoch, bi))
                after(s["calls"], metrics)
            pending.append(metrics["loss"])
            s["calls"] += 1
            if len(pending) >= every:
                flush()
        flush()
        return s

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        s = self._loop(until=t0 + seconds)
        s["window_s"] = time.perf_counter() - t0
        s["items"] = s["calls"] * self.batch
        s["attempted"] = s["calls"]
        self.stats = s

    def end_to_end(self) -> dict:
        return {"samples_per_s": self.stats["items"] / self.stats["window_s"]}

    def work(self) -> dict:
        m = self.cell.config["model"]
        h, w = self.tr["crop"]
        return {"flops_per_call": work.conv_flops(m, self.batch, h, w, train=True),
                "ops_per_call": work.port_ops(m, self.batch, h, w, train=True)}

    def release(self) -> None:
        self.it.close()
        del self.it, self.loader, self.step, self.state, self.params
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------------------
    def reference(self, tf32: bool = False, rows: slice = slice(None)) -> dict:
        """The reference's three steps from the weights file on the checked batches."""
        params0 = weights.load_npz(str(self.cell.weights), self.device)
        batches, seeds = [], []
        for epoch, bi in self.first:
            r = torch.from_numpy(self._rows(epoch)[bi * self.batch:(bi + 1) * self.batch])
            batches.append(tuple(self.pool[k][r].to(self.device) for k in ("img1", "img2", "flow")))
            seeds.append(step_seed(self.run_seed, epoch, bi))
        return ref_train.steps(params0, self.cell.config["model"], batches, seeds, self.tr["crop"],
                               self.cell.config["optim"], tf32=tf32, rows=rows)

    def check(self, got=None, ref=None) -> dict:
        """The compared numbers (:func:`compare`) of the program's readings, or of ``got`` (the
        control) in their place, against ``ref`` (by default the reference's own run)."""
        got = self.readings if got is None else got
        ref = self.reference() if ref is None else ref
        if len(got.get("losses", [])) < CHECKED_STEPS or "grad" not in got or "change" not in got:
            return {name: float("nan") for name in self.cell.checks["limits"]}
        return compare(got, ref)

    def calibration(self, control: bool) -> dict:
        """The readings a limit is set from: the program's numbers and, with ``control``, the
        control's (the reference with TF32 on, in the program's place) and those of the fault
        that leaves half of each batch out; ``raw`` holds every side's losses and leaves."""
        ref = self.reference()
        out = {"program": self.check(ref=ref)}
        if control:
            ctl, half = self.reference(tf32=True), self.reference(rows=slice(0, self.batch // 2))
            out.update(control=self.check(ctl, ref), half_batch=self.check(half, ref),
                       raw={"program": self.readings, "ref": ref, "control": ctl, "half_batch": half})
        return out
