#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives PIV-LiteFlowNet-en version 1 inference and training through the
port's entry points (``piv_liteflownet``, ``estimate``, ``write_flow``/
``read_flow``; ``make_optimizer``, ``make_train_step``, ``Train``, ``resume``)
at full width with seeded random weights, in five phases; each raises on
failure, and then the script exits non-zero without the final line.

1. Card and build: the card's name and power limit (nvidia-smi), and the
   ``nvcc`` build of ``piv_liteflownet_tpu_torch/csrc/*.cu`` with its seconds.
2. Each CUDA kernel against its plain PyTorch version on the card, at the
   shapes a 1024x1024 pair gives it at every pyramid level and at odd sizes,
   with flows that point outside the frame; the two backward kernels also at
   the shapes of a 256^2 batch-8 training step. Tolerance: atol 1e-5 for the
   warps; 1e-5 * mean|f1*f2| for the cost volume (another summation order);
   1e-5 * max|plain| for the backward kernels (atomics in a varying order,
   sums over 49 taps or C channels).
3. The slice end to end on synthetic particle-image pairs: ``estimate`` at
   1024^2 b1 (the main path: the launch counts are set to 0 just before it
   and read just after), 256^2 b4 and 250x300 b1 (through the /32 resize);
   finite outputs, the same model through the plain ops on the card (atol
   2e-4, rtol 1e-3, the tolerance of tests/test_model_parity.py), the CPU
   model at 250x300, launches per forward, and a ``.flo`` round trip.
4. Times: estimate ms/pair (median and p90 of 100 calls, host clock around
   synchronised calls) and pairs/s, and with CUDA events each kernel at
   its level-1 shape beside its plain version, the one PyTorch call that
   computes the same function where there is one (``library_ms``; the port
   never calls it), and its bound from the bytes and operations it needs.
5. Training at 256^2 batch 8 on synthetic particle pairs: one train step
   through the kernels (the training path: the launch counts are set to 0
   just before it and read just after) and one through the plain ops from
   the same weights, their gradients compared (rtol 1e-3, atol 1e-4 *
   max|g| per parameter, the tolerance of tests/test_torch_train.py; TF32
   off); then steps on the one batch, whose loss must be finite and fall,
   timed (median of 25 synchronised steps) with the peak device memory;
   then two epochs of ``Train`` with checkpoints, restored with ``resume``
   and compared with the state in memory; and the backward kernels' times.

The line before the last is ``{"kernels": [...]}`` (``launches``: per
estimate for the forward kernels, per train step for the backward ones;
``launches_per_train_step`` for all five); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 rate outside the tensor cores
WARP_ATOL = 1e-5
CORR_RTOL = 1e-5
MODEL_ATOL, MODEL_RTOL = 2e-4, 1e-3
BWD_RTOL = 1e-5             # backward kernels: atol 1e-5 * max|plain|
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4  # train step, kernels vs plain ops, per parameter
MAIN_H = MAIN_W = 1024
TRAIN_B, TRAIN_H, TRAIN_W = 8, 256, 256
TRAIN_STEPS = 25  # timed steps (median); 3 more warm up
ESTIMATE_ITERS = 100  # p90 then has ten samples beyond it


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- inputs -------------------------------------------------------------------------

def randn(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, device=dev, generator=g)


def uniform(shape, seed, dev, lo, hi):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, device=dev, generator=g) * (hi - lo) + lo


def smooth_flow(b: int, h: int, w: int, dev) -> torch.Tensor:
    """A smooth PIV-like displacement field in pixels: a shift plus waves of a few pixels."""
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    u = 1.5 + 3.0 * torch.sin(2 * torch.pi * ys / 256) * torch.cos(2 * torch.pi * xs / 384)
    v = -0.5 + 2.0 * torch.cos(2 * torch.pi * xs / 300)
    return torch.stack([u.expand(h, w), v.expand(h, w)])[None].repeat(b, 1, 1, 1).contiguous()


# -- phase 2: kernels against their plain versions -------------------------------------

def level_shapes(h: int, w: int):
    """Per pyramid level of PIV-LiteFlowNet-en v1 on an h x w pair: (level, size, channels of M/S)."""
    chans = {1: 64, 2: 64, 3: 64, 4: 96, 5: 128, 6: 192}  # NetC_ext lifts levels 1-2 to 64
    return [(lv, (h >> (lv - 1), w >> (lv - 1)), chans[lv]) for lv in range(1, 7)]


def check_kernels(dev, ops):
    corr, warp, rgb = ops
    errs = {"corr49": 0.0, "backwarp": 0.0, "rgb_warp_norm": 0.0, "backwarp_bwd": 0.0,
            "corr49_bwd": 0.0}
    failures = []

    def record(name, what, err, tol):
        errs[name] = max(errs[name], err)
        ok = err <= tol
        log(f"  {name:14s} {what:44s} max_abs_err {err:.3e}  tol {tol:.3e}  {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} {what}")

    seed = 0
    corr_cases, warp_cases, rgb_cases = [], [], []
    for lv, (h, w), c in level_shapes(MAIN_H, MAIN_W):
        s = 2 if lv < 4 else 1
        corr_cases.append((1, c, -(-h // s), -(-w // s)))
        warp_cases.append((1, c, h, w, 1, 8.0))          # NetE-S warp
        if lv < 6:
            warp_cases.append((1, c, h, w, s, 8.0))      # NetE-M warp
        rgb_cases.append((1, h, w, 8.0))
    corr_cases += [(2, 3, 37, 53), (1, 64, 37, 53), (4, 64, 64, 64)]
    warp_cases += [(2, 5, 37, 53, 1, 30.0), (2, 7, 37, 53, 2, 30.0), (4, 64, 128, 128, 2, 8.0)]
    rgb_cases += [(2, 37, 53, 30.0), (4, 256, 256, 8.0)]

    for b, c, h, w in corr_cases:
        seed += 1
        f1, f2 = randn((b, c, h, w), seed, dev), randn((b, c, h, w), seed + 1000, dev)
        got = corr.corr49(f1, f2)
        torch.cuda.synchronize()
        want = corr.corr49_plain(f1, f2)
        tol = CORR_RTOL * float((f1 * f2).abs().mean())
        record("corr49", f"[{b},{c},{h},{w}]", float((got - want).abs().max()), tol)
    for b, c, h, w, s, mag in warp_cases:
        seed += 1
        img = randn((b, c, h, w), seed, dev)
        ho, wo = warp.out_hw(h, w, s)
        flow = uniform((b, 2, ho, wo), seed + 1000, dev, -mag, mag)
        got = warp.backwarp(img, flow, s)
        torch.cuda.synchronize()
        want = warp.backwarp_plain(img, flow, s)
        record("backwarp", f"[{b},{c},{h},{w}] stride {s} |flow|<={mag:g}",
               float((got - want).abs().max()), WARP_ATOL)
    for b, h, w, mag in rgb_cases:
        seed += 1
        img1, img2 = uniform((b, 3, h, w), seed, dev, 0, 1), uniform((b, 3, h, w), seed + 7, dev, 0, 1)
        flow = uniform((b, 2, h, w), seed + 1000, dev, -mag, mag)
        got = rgb.rgb_warp_norm(img1, img2, flow)
        torch.cuda.synchronize()
        want = rgb.rgb_warp_norm_plain(img1, img2, flow)
        record("rgb_warp_norm", f"[{b},3,{h},{w}] |flow|<={mag:g}",
               float((got - want).abs().max()), WARP_ATOL)
    # the backward kernels, through autograd: at the 1024^2 level shapes and at the
    # 256^2 batch-8 training shapes, with steep flows, and at odd sizes far outside
    bwd_warp_cases = list(warp_cases[:11])  # the 1024^2 level shapes
    bwd_corr_cases = list(corr_cases[:6])
    for lv, (h, w), c in level_shapes(TRAIN_H, TRAIN_W):
        s = 2 if lv < 4 else 1
        bwd_corr_cases.append((TRAIN_B, c, -(-h // s), -(-w // s)))
        bwd_warp_cases.append((TRAIN_B, c, h, w, 1, 8.0))
        if lv < 6:
            bwd_warp_cases.append((TRAIN_B, c, h, w, s, 8.0))
    bwd_warp_cases += [(2, 5, 37, 53, 1, 30.0), (2, 7, 37, 53, 2, 30.0)]
    bwd_corr_cases += [(2, 3, 37, 53)]
    for b, c, h, w, s, mag in bwd_warp_cases:
        seed += 1
        img = randn((b, c, h, w), seed, dev).requires_grad_()
        ho, wo = warp.out_hw(h, w, s)
        flow = uniform((b, 2, ho, wo), seed + 1000, dev, -mag, mag).requires_grad_()
        gout = randn((b, c, ho, wo), seed + 2000, dev)
        warp.backwarp(img, flow, s).backward(gout)
        torch.cuda.synchronize()
        want_img, want_flow = warp.backwarp_bwd_plain(img.detach(), flow.detach(), gout, s)
        err = max(float((img.grad - want_img).abs().max()), float((flow.grad - want_flow).abs().max()))
        tol = BWD_RTOL * max(float(want_img.abs().max()), float(want_flow.abs().max()), 1.0)
        record("backwarp_bwd", f"[{b},{c},{h},{w}] stride {s} |flow|<={mag:g}", err, tol)
        del img, flow, gout, want_img, want_flow
    for b, c, h, w in bwd_corr_cases:
        seed += 1
        f1 = randn((b, c, h, w), seed, dev).requires_grad_()
        f2 = randn((b, c, h, w), seed + 1000, dev).requires_grad_()
        g = randn((b, 49, h, w), seed + 2000, dev)
        corr.corr49(f1, f2).backward(g)
        torch.cuda.synchronize()
        want1, want2 = corr.corr49_bwd_plain(f1.detach(), f2.detach(), g)
        err = max(float((f1.grad - want1).abs().max()), float((f2.grad - want2).abs().max()))
        tol = BWD_RTOL * max(float(want1.abs().max()), float(want2.abs().max()), 1.0)
        record("corr49_bwd", f"[{b},{c},{h},{w}]", err, tol)
        del f1, f2, g, want1, want2
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return errs


# -- phase 3: the slice end to end -------------------------------------------------------

def close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=MODEL_ATOL, rtol=MODEL_RTOL, msg=lambda m: f"{what}: {m}")
    return err


def run_slice(dev, ops):
    from piv_liteflownet_tpu_torch import piv_liteflownet
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS
    from piv_liteflownet_tpu_torch.utils.flow_io import read_flow, write_flow
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    corr, warp, rgb = ops
    model = piv_liteflownet(version=1, seed=0)
    expected = (6, 11, 6)  # corr49 (one per level), backwarp (5 M + 6 S), rgb_warp_norm
    results = {}
    for b, h, w, seed in ((1, MAIN_H, MAIN_W, 1), (4, 256, 256, 2), (1, 250, 300, 3)):
        im1, im2 = particle_pair(b, h, w, seed)
        t1, t2 = torch.from_numpy(im1).to(dev), torch.from_numpy(im2).to(dev)
        torch.cuda.synchronize()
        reset_counts(ops)
        flow = estimate(model, t1, t2, tensor=True)
        torch.cuda.synchronize()
        counts = (corr.launches, warp.launches, rgb.launches)
        if (b, h, w) == (1, MAIN_H, MAIN_W):
            results["launches"] = dict(zip(("corr49", "backwarp", "rgb_warp_norm"), counts))
        if counts != expected:
            raise AssertionError(f"{b}x{h}x{w}: launches {counts} per forward, expected {expected}")
        if tuple(flow.shape) != (b, h, w, 2) or not bool(torch.isfinite(flow).all()):
            raise AssertionError(f"{b}x{h}x{w}: bad flow, shape {tuple(flow.shape)}")
        plain = estimate(model, t1, t2, tensor=True, ops=PLAIN_OPS)
        err = close(flow, plain, f"{b}x{h}x{w} kernels vs plain ops")
        log(f"  estimate b{b} {h}x{w}: launches corr49/backwarp/rgb_warp_norm = {counts}, "
            f"|flow| mean {float(flow.norm(dim=-1).mean()):.4f}, max_abs_err vs plain ops {err:.3e}")
        if (h, w) == (250, 300):
            cpu_model = piv_liteflownet(version=1, seed=0, device="cpu")
            ref = estimate(cpu_model, im1, im2, tensor=True)
            err = close(flow.cpu(), ref, "250x300 card vs CPU")
            log(f"  estimate b1 250x300: max_abs_err card vs CPU plain path {err:.3e}")
            with tempfile.TemporaryDirectory() as tmp:
                path = str(Path(tmp) / "pair_out.flo")
                arr = flow[0].cpu().numpy()
                write_flow(arr, path)
                if not np.array_equal(read_flow(path), arr):
                    raise AssertionError(".flo round trip changed the flow")
            log("  .flo round trip: ok")
    results["model"] = model
    return results


# -- phase 4: times -------------------------------------------------------------------------

class Timer:
    """Kernel times with CUDA events; the 50 MB L2 is flushed before each launch."""

    def __init__(self, dev):
        self.flush_buf = torch.empty(128 * 2**20 // 4, device=dev)

    def __call__(self, fn, iters=30, warmup=3) -> float:
        """Median ms of ``iters`` launches of ``fn``, each timed alone after an L2 flush."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(iters):
            self.flush_buf.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        return float(np.median(samples))


def pixel_grid(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """grid_sample grid (align_corners=True) that samples at (x + u, y + v)."""
    xs = torch.arange(w, device=flow.device, dtype=torch.float32) + flow[:, 0]
    ys = torch.arange(h, device=flow.device, dtype=torch.float32)[:, None] + flow[:, 1]
    return torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], dim=-1)


def bound_ms(nbytes: float, flops: float):
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def time_estimate(fn, b: int, what: str, card: str) -> None:
    """Median and p90 of ``ESTIMATE_ITERS`` synchronised calls of ``fn`` (one batch of ``b`` pairs)."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(ESTIMATE_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    med, p90 = np.percentile(samples, [50, 90])
    log(f"  estimate {what}: {med / b:.3f} ms/pair median, p90 {p90 / b:.3f} "
        f"({len(samples)} calls), {1e3 * b / med:.2f} pairs/s ({card})")


def time_all(dev, ops, model, card):
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    corr, warp, rgb = ops
    for b, h, w in ((1, MAIN_H, MAIN_W), (4, 256, 256)):
        im1, im2 = particle_pair(b, h, w, seed=10 + b)
        t1, t2 = torch.from_numpy(im1).to(dev), torch.from_numpy(im2).to(dev)
        time_estimate(lambda: estimate(model, t1, t2, tensor=True), b,
                      f"{h}x{w} b{b}, inputs and flow on the card", card)
    # what run.py pays per pair: numpy frames in, numpy flow out
    im1, im2 = particle_pair(1, MAIN_H, MAIN_W, seed=12)
    time_estimate(lambda: estimate(model, im1[0], im2[0]), 1,
                  f"{MAIN_H}x{MAIN_W} b1, numpy in and out", card)

    timer = Timer(dev)
    rows = {}
    # corr49 at level 1: f1, f2 subsampled to 512^2 with 64 channels
    b, c, h, w = 1, 64, MAIN_H // 2, MAIN_W // 2
    f1, f2 = randn((b, c, h, w), 1, dev), randn((b, c, h, w), 2, dev)
    rows["corr49"] = dict(
        ms=timer(lambda: corr.corr49(f1, f2)), plain_ms=timer(lambda: corr.corr49_plain(f1, f2)),
        library_ms=None, shape=f"[{b},{c},{h},{w}]",
        bound=bound_ms(4 * (2 * c + 49) * b * h * w, 2 * 49 * c * b * h * w))
    # backwarp at level 1: the NetE-S warp of a 64-channel 1024^2 map
    b, c, h, w = 1, 64, MAIN_H, MAIN_W
    img, flow = randn((b, c, h, w), 3, dev), smooth_flow(b, h, w, dev)
    grid = pixel_grid(flow, h, w)
    rows["backwarp"] = dict(
        ms=timer(lambda: warp.backwarp(img, flow)), plain_ms=timer(lambda: warp.backwarp_plain(img, flow)),
        library_ms=timer(lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                               align_corners=True)),
        shape=f"[{b},{c},{h},{w}] stride 1",
        bound=bound_ms(4 * (2 * c + 2) * b * h * w, 8 * c * b * h * w))
    # the same warp with an independent random flow per pixel (uncoalesced taps)
    flow_r = uniform((b, 2, h, w), 4, dev, -8, 8)
    grid_r = pixel_grid(flow_r, h, w)
    log(f"  backwarp [1,64,{h},{w}] stride 1, random |flow|<=8: "
        f"{timer(lambda: warp.backwarp(img, flow_r)):.4f} ms, grid_sample "
        f"{timer(lambda: F.grid_sample(img, grid_r, align_corners=True)):.4f} ms")
    # the NetE-M stride-2 warp at level 1, printed beside it
    flow2 = smooth_flow(b, h // 2, w // 2, dev)
    m2 = timer(lambda: warp.backwarp(img, flow2, 2))
    log(f"  backwarp [1,64,{h},{w}] stride 2 (NetE-M, level 1): {m2:.4f} ms; bound "
        f"{bound_ms(4 * (c * h * w + (c + 2) * h * w // 4), 2 * c * h * w)[0]:.4f} ms (bytes)")
    # rgb_warp_norm at level 1: 1024^2
    b, h, w = 1, MAIN_H, MAIN_W
    img1, img2 = uniform((b, 3, h, w), 6, dev, 0, 1), uniform((b, 3, h, w), 7, dev, 0, 1)
    flow = smooth_flow(b, h, w, dev)
    grid = pixel_grid(flow, h, w)
    rows["rgb_warp_norm"] = dict(
        ms=timer(lambda: rgb.rgb_warp_norm(img1, img2, flow)),
        plain_ms=timer(lambda: rgb.rgb_warp_norm_plain(img1, img2, flow)),
        library_ms=timer(lambda: F.grid_sample(img2, grid, mode="bilinear", padding_mode="zeros",
                                               align_corners=True)),
        shape=f"[{b},3,{h},{w}]",
        bound=bound_ms(4 * (3 + 3 + 2 + 1) * b * h * w, 27 * b * h * w))
    for name, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name:14s} {r['shape']:26s} {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {lib} ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]})  ({card})")
    return rows


# -- phase 5: training -------------------------------------------------------------------------

def reset_counts(ops) -> None:
    corr, warp, rgb = ops
    corr.launches = warp.launches = rgb.launches = 0
    corr.bwd_launches = warp.bwd_launches = 0


def read_counts(ops) -> dict:
    corr, warp, rgb = ops
    return {"corr49": corr.launches, "backwarp": warp.launches, "rgb_warp_norm": rgb.launches,
            "corr49_bwd": corr.bwd_launches, "backwarp_bwd": warp.bwd_launches}


def run_training(dev, ops, card):
    from piv_liteflownet_tpu_torch import piv_liteflownet
    from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, PLAIN_OPS
    from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_eval_step, make_train_step
    from piv_liteflownet_tpu_torch.trainer import Train, TrainArgs, resume
    from piv_liteflownet_tpu_torch.training.loss import piv_loss
    from piv_liteflownet_tpu_torch.training.optim import make_optimizer
    from piv_liteflownet_tpu_torch.utils.metrics import Experiment
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    shift = (2.5, -1.5)
    im1, im2 = particle_pair(TRAIN_B, TRAIN_H, TRAIN_W, seed=20, shift=shift)
    target = np.empty((TRAIN_B, TRAIN_H, TRAIN_W, 2), np.float32)
    target[...] = shift
    batch = tuple(torch.from_numpy(a).to(dev) for a in (im1, im2, target))
    loss_obj = piv_loss()

    def build(ops_):
        model = piv_liteflownet(version=1, seed=0)
        opt = make_optimizer(model, model.cfg.lowest_level)
        return TrainState(model, opt), make_train_step(model.cfg, loss_obj, opt, ops=ops_)

    # the training path: one step through the kernels, counts read around it
    state, step = build(KERNEL_OPS)
    torch.cuda.synchronize()
    reset_counts(ops)
    state, metrics = step(state, *batch)
    torch.cuda.synchronize()
    counts = read_counts(ops)
    expected = {"corr49": 6, "backwarp": 11, "rgb_warp_norm": 6, "corr49_bwd": 6, "backwarp_bwd": 11}
    if counts != expected:
        raise AssertionError(f"train step launches {counts}, expected {expected}")
    grads_k = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    loss_k = float(metrics["loss"])

    plain_state, plain_step = build(PLAIN_OPS)
    _, plain_metrics = plain_step(plain_state, *batch)
    torch.cuda.synchronize()
    if read_counts(ops) != expected:
        raise AssertionError("the plain-ops step launched a kernel")
    loss_p = float(plain_metrics["loss"])
    worst, worst_name = 0.0, ""
    for n, p in plain_state.model.named_parameters():
        g = p.grad
        torch.testing.assert_close(grads_k[n], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(g.abs().max()), msg=lambda m: f"{n}: {m}")
        rel = float((grads_k[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise AssertionError(f"train loss kernels {loss_k} vs plain ops {loss_p}")
    del plain_state, plain_step, grads_k
    log(f"  train step {TRAIN_H}x{TRAIN_W} b{TRAIN_B}: launches {counts}; loss kernels {loss_k:.6f} plain {loss_p:.6f}; "
        f"grads within tolerance, worst max|dg|/max|g| {worst:.3e} ({worst_name})")

    # repeated steps on the one batch: finite, falling loss; ms/step
    losses = [loss_k]
    for _ in range(3):
        state, metrics = step(state, *batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    samples = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, *batch)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"training loss did not fall on one batch: {losses}")
    med, p90 = np.percentile(samples, [50, 90])
    log(f"  loss over {len(losses)} steps on one batch: {losses[0]:.6f} -> {losses[-1]:.6f} "
        f"(mean of the last 5 {np.mean(losses[-5:]):.6f})")
    log(f"  train step {TRAIN_H}x{TRAIN_W} b{TRAIN_B}: {med:.3f} ms/step median, p90 {p90:.3f} ({TRAIN_STEPS} steps), "
        f"{1e3 * TRAIN_B / med:.2f} samples/s; peak memory {peak / 2**30:.3f} GiB ({card})")

    # the epoch loop with checkpoints, then resume into a fresh model and optimizer
    train_batches = [((im1, im2), target)] * 2
    val_batches = [((im1[:2], im2[:2]), target[:2])]
    with tempfile.TemporaryDirectory() as tmp:
        args = TrainArgs(model="piv_liteflownet", total_epochs=2, backup_frequency=1, save=tmp)
        experiment = Experiment(workdir=str(Path(tmp) / "exp"))
        trainer = Train(args, experiment, {"train": train_batches, "val": val_batches}, state, step,
                        make_eval_step(state.model.cfg, loss_obj))
        trainer()
        experiment.close()
        torch.cuda.synchronize()
        names = sorted(p.name for p in Path(tmp).iterdir())
        for want in ("backup_1", "backup_2", "piv_liteflownet_checkpoint", "piv_liteflownet_model_best"):
            if want not in names:
                raise AssertionError(f"checkpoint {want} missing: {names}")
        fresh, _ = build(KERNEL_OPS)
        fresh_args = TrainArgs(model="piv_liteflownet", total_epochs=2, save=tmp)
        resume(fresh, str(Path(tmp) / "backup_2"), fresh_args)
        live = trainer.state
        same = all(torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                                      live.model.state_dict().values()))
        ls, fs = live.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
        same = same and ls.keys() == fs.keys() and all(
            torch.equal(ls[i][k], fs[i][k]) for i in ls for k in ("exp_avg", "exp_avg_sq"))
        if not same or fresh.step != live.step or fresh_args.start_epoch != 3:
            raise AssertionError("the restored checkpoint differs from the state in memory")
        log(f"  Train: 2 epochs of 2 steps + validation, checkpoints {names}; resume from backup_2 "
            f"restores params, Adam moments and step {fresh.step} exactly")
    return {"launches": counts, "ms_step": med, "p90": p90, "peak": peak}


def time_backward(dev, ops, card):
    """Each backward kernel at its level-1 shape of a 256^2 batch-8 training step."""
    corr, warp, _ = ops
    timer = Timer(dev)
    rows = {}
    b, c, h, w = TRAIN_B, 64, TRAIN_H, TRAIN_W
    img, flow = randn((b, c, h, w), 31, dev), smooth_flow(b, h, w, dev)
    gout = randn((b, c, h, w), 32, dev)
    g_img, g_flow = torch.empty_like(img), torch.empty_like(flow)
    grid = pixel_grid(flow, h, w)
    rows["backwarp_bwd"] = dict(
        ms=timer(lambda: warp._launch_bwd(img, flow, gout, 1, g_img, g_flow)),
        plain_ms=timer(lambda: warp.backwarp_bwd_plain(img, flow, gout)),
        library_ms=timer(lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, img, grid, 0, 0, True, [True, True])),
        shape=f"[{b},{c},{h},{w}] stride 1",
        bound=bound_ms(4 * (3 * b * c * h * w + 4 * b * h * w), 24 * b * c * h * w))
    flow_r = uniform((b, 2, h, w), 33, dev, -8, 8)
    grid_r = pixel_grid(flow_r, h, w)
    log(f"  backwarp_bwd [{b},{c},{h},{w}] stride 1, random |flow|<=8: "
        f"{timer(lambda: warp._launch_bwd(img, flow_r, gout, 1, g_img, g_flow)):.4f} ms, "
        f"grid_sampler_2d_backward {timer(lambda: torch.ops.aten.grid_sampler_2d_backward(gout, img, grid_r, 0, 0, True, [True, True])):.4f} ms")
    flow2 = smooth_flow(b, h // 2, w // 2, dev)
    gout2 = randn((b, c, h // 2, w // 2), 34, dev)
    g_flow2 = torch.empty_like(flow2)
    m2 = timer(lambda: warp._launch_bwd(img, flow2, gout2, 2, g_img, g_flow2))
    log(f"  backwarp_bwd [{b},{c},{h},{w}] stride 2 (NetE-M, level 1): {m2:.4f} ms; bound "
        f"{bound_ms(4 * (2 * b * c * h * w + b * c * h * w // 4 + b * h * w), 6 * b * c * h * w)[0]:.4f} ms (bytes)")
    del img, gout, g_img, grid, flow_r, grid_r, gout2
    b, c, h, w = TRAIN_B, 64, TRAIN_H // 2, TRAIN_W // 2
    f1, f2, g = randn((b, c, h, w), 35, dev), randn((b, c, h, w), 36, dev), randn((b, 49, h, w), 37, dev)
    g_f1, g_f2 = torch.empty_like(f1), torch.empty_like(f2)
    rows["corr49_bwd"] = dict(
        ms=timer(lambda: corr._launch_bwd(f1, f2, g, g_f1, g_f2)),
        plain_ms=timer(lambda: corr.corr49_bwd_plain(f1, f2, g)), library_ms=None,
        shape=f"[{b},{c},{h},{w}]",
        bound=bound_ms(4 * (4 * c + 49) * b * h * w, 2 * 2 * 49 * c * b * h * w))
    for name, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name:14s} {r['shape']:26s} {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {lib} ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]})  ({card})")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr, flush=True)
        return 2
    from piv_liteflownet_tpu_torch.kernels import build
    from piv_liteflownet_tpu_torch.ops import correlation, rgb_warp, warp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("phase 1: card and build")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    res = build.build()
    log(f"  kernel build: {res.seconds:.2f} s ({'built' if res.rebuilt else 'up to date'}) -> {res.path}")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"    {line.strip()}")
    build.load()

    ops = (correlation, warp, rgb_warp)
    log("phase 2: kernels against their plain versions")
    errs = check_kernels(dev, ops)

    log("phase 3: estimate end to end")
    sl = run_slice(dev, ops)

    log("phase 4: times")
    rows = time_all(dev, ops, sl["model"], card)
    del sl["model"]

    log("phase 5: training")
    tr = run_training(dev, ops, card)
    rows.update(time_backward(dev, ops, card))

    sources = {"corr49": "corr49.cu", "backwarp": "backwarp.cu", "rgb_warp_norm": "rgb_warp_norm.cu",
               "backwarp_bwd": "backwarp_bwd.cu", "corr49_bwd": "corr49_bwd.cu"}
    replaces = {
        "corr49": "piv_liteflownet_tpu/ops/pallas_corr.py:66,162",
        "backwarp": "piv_liteflownet_tpu/ops/pallas_feat_warp.py:115",
        "rgb_warp_norm": "piv_liteflownet_tpu/ops/pallas_rgb_warp.py:119",
        "backwarp_bwd": "piv_liteflownet_tpu/ops/pallas_warp_vjp.py:119",
        # no TPU kernel: JAX takes the XLA VJP of the shift-stack there
        "corr49_bwd": "piv_liteflownet_tpu/ops/correlation.py:85",
    }
    # launches: the estimate path for the forward kernels, the train step for the backward ones
    launches = {**sl["launches"], "backwarp_bwd": tr["launches"]["backwarp_bwd"],
                "corr49_bwd": tr["launches"]["corr49_bwd"]}
    kernels = [dict(
        name=name, route="cuda", source=f"piv_liteflownet_tpu_torch/csrc/{sources[name]}",
        replaces=replaces[name], launches=launches[name],
        launches_per_train_step=tr["launches"][name], max_abs_err=errs[name],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
        library_ms=r["library_ms"]) for name, r in rows.items()]
    if any(k["launches"] == 0 or k["launches_per_train_step"] == 0 for k in kernels):
        raise AssertionError(f"a kernel of a path never launched: {launches}, {tr['launches']}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
