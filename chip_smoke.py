#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives PIV-LiteFlowNet-en version 1 inference through the port's entry
points (``piv_liteflownet``, ``estimate``, ``write_flow``/``read_flow``) at
full width with seeded random weights, in four phases; each raises on
failure, and then the script exits non-zero without the final line.

1. Card and build: the card's name and power limit (nvidia-smi), and the
   ``nvcc`` build of ``piv_liteflownet_tpu_torch/csrc/*.cu`` with its seconds.
2. Each CUDA kernel against its plain PyTorch version on the card, at the
   shapes a 1024x1024 pair gives it at every pyramid level and at odd sizes,
   with flows that point outside the frame. Tolerance: atol 1e-5 for the
   warps; 1e-5 * mean|f1*f2| for the cost volume (another summation order).
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

The line before the last is ``{"kernels": [...]}``; the last line is
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
MAIN_H = MAIN_W = 1024
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
    errs = {"corr49": 0.0, "backwarp": 0.0, "rgb_warp_norm": 0.0}
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
        corr.launches = warp.launches = rgb.launches = 0
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

    sources = {"corr49": "corr49.cu", "backwarp": "backwarp.cu", "rgb_warp_norm": "rgb_warp_norm.cu"}
    replaces = {
        "corr49": "piv_liteflownet_tpu/ops/pallas_corr.py:66,162",
        "backwarp": "piv_liteflownet_tpu/ops/pallas_feat_warp.py:115",
        "rgb_warp_norm": "piv_liteflownet_tpu/ops/pallas_rgb_warp.py:119",
    }
    kernels = [dict(
        name=name, route="cuda", source=f"piv_liteflownet_tpu_torch/csrc/{sources[name]}",
        replaces=replaces[name], launches=sl["launches"][name], max_abs_err=errs[name],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
        library_ms=r["library_ms"]) for name, r in rows.items()]
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError(f"a kernel of the main path never launched: {sl['launches']}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
