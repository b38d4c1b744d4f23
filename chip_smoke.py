#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py [--parent DIR]

It drives PIV-LiteFlowNet-en version 1 inference and training, and
PIV-LiteFlowNet2-en and Hui LiteFlowNet2 (version 2) inference and training,
also with the NetE conv stacks through the ``conv_chain`` kernel
(``conv_impl="chain"``) and in bf16 (inference: the models cast with
``.to(torch.bfloat16)``; training: ``compute_dtype=torch.bfloat16``),
through the port's entry points (``piv_liteflownet``,
``hui_liteflownet``, ``estimate``, ``write_flow``/``read_flow``;
``make_optimizer``, ``make_train_step``, ``Train``, ``resume``) at full width
with seeded random weights, in five phases; each raises on failure, and then
the script exits non-zero without the final line.

1. Card and build: the card's name and power limit (nvidia-smi), and the
   ``nvcc`` build of ``piv_liteflownet_tpu_torch/csrc/*.cu`` with its seconds
   and ``ptxas``'s registers and spills for every kernel.
2. Each CUDA kernel against its plain PyTorch version on the card, at the
   shapes a 1024x1024 pair gives it at every pyramid level and at odd sizes,
   with flows that point outside the frame; the two backward kernels also at
   the shapes of a 256^2 batch-8 training step; ``conv_chain`` at the piv v1
   level-1 M, S and R stacks of a 1024^2 pair, the 6-conv v2 stacks and odd
   sizes (batch 2 at 123x77, off every tile edge, for the tensor-core
   tiling); ``backwarp_bwd`` also with a smooth and a 30 px random flow at the
   level-1 training shape at both strides, its count of tiles that took the
   out-of-window path held to ``ops/warp.py:tile_windows`` in every case, and
   both of its paths required to run; the two cost-volume kernels also at
   odd widths, maps smaller than the 7x7 window (down to 1x1), one channel and
   192 channels at 8x8, their count of tiles that took the edge path (4-byte
   staging) held to ``ops/correlation.py:tile_plan`` in every case, and both
   of their paths required to run. Tolerance: atol 1e-5 for the warps;
   1e-5 * mean|f1*f2| for the
   cost volume (another summation order); 1e-5 * max|plain| for the backward
   kernels (atomics in a varying order, sums over 49 taps or C channels) and
   for ``conv_chain`` (float32-accurate sums over up to 3474 taps per layer
   in another order than cuDNN's, through up to 6 layers: 3xTF32 on the
   tensor cores, whose dropped lo*lo term is below 2^-22 of a product;
   single-pass TF32 would miss this tolerance). Then the bf16 forms of
   ``corr49``, ``backwarp`` and ``rgb_warp_norm`` at the same level shapes,
   flows of up to 30 px at both strides, and the cost volume's edge path
   (widths not a multiple of 8, a tensor 2 bytes off 16; its tile count
   held to ``tile_plan`` and both paths required): each held to the
   float32 plain version on the bf16 inputs upcast to float32, then rounded
   to bf16, within one bf16 ulp of that reference plus the float32 kernel's
   own tolerance, elementwise, and a second launch of the cost volume's bf16
   form bit-equal to the first; ``backwarp``'s bf16 form also at odd widths and
   channel counts (5, 7, 33, 192), widths a multiple of 8 and a tensor 2 bytes
   off 16, its count of tiles that gathered directly held to
   ``ops/warp.py:staged_tiles`` and both of its paths required. Then, the
   same way through autograd, the bf16 forms of the two backward kernels:
   ``backwarp_bwd`` at the level-1 shape of a 256^2 batch-8 training step at
   both strides with a smooth and a 30 px random flow, at odd sizes and
   channel counts (5, 7, 33), and with a converging (zoom) and a spike flow
   (its count of owner rectangles on the slower path held to
   ``ops/warp.py:owner_rects``, both paths required, and a second launch
   bit-equal to the first), ``corr49_bwd`` at the training step's level
   shapes and its edge shapes, widths a multiple of 4 but not of 8 among
   them (its edge count held to ``tile_plan``, both paths required, and a
   second launch bit-equal to the first).
   Then the bf16 form of ``conv_chain``: one conv of k = 1, 3, 5 and 7 on the
   tensor-core and the FFMA path, held as above (one bf16 ulp of the rounded
   float32 plain version, plus its 1e-5 * max|plain|), and every stack
   above, whose error against the float32 kernel on the same bf16 values
   must stay within twice the plain bf16 chain's (which rounds once per
   layer, as the kernel and the TPU kernel do).
3. The slices end to end on synthetic particle-image pairs: ``estimate`` of
   piv v1, piv v2 and hui v2, with cuDNN convs and with the conv chain, at
   1024^2 b1, 256^2 b4 and 250x300 b1 (through the /32 resize). Each path is
   driven with the launch counts set to 0 just before it and read just after:
   piv v1 at 1024^2 is the first slice's main path, piv v2 with the chain at
   1024^2 this slice's. Finite outputs, the same model through the plain ops
   on the card (atol 2e-4, rtol 1e-3, the tolerance of
   tests/test_model_parity.py), the CPU model at 250x300, launches per
   forward, a ``.flo`` round trip; and one ``estimate`` under torch's default
   flags (cuDNN TF32 on), held to the CPU plain path and to the call with
   TF32 off, beside the size of the TF32 error of an unpinned forward.
   Then bf16 inference: ``estimate`` of piv v1, piv v2 and hui v2 cast to
   bf16, with cuDNN convs and with the conv chain (this slice's main path:
   piv v1 with the chain at 1024^2 b1), at 1024^2 b1, 256^2 b4 and 250x300,
   with the counts set to 0 just before and read just after (only the
   ``_bf16`` forms may launch: 6/11/6 for v1, and 18 ``conv_chain_bf16``
   with the chain), the flow held to the float32 flow of the same weights,
   to the bf16 plain ops on the card, with the chain to the bf16 cuDNN path,
   and to the bf16 CPU path within 3 % of the float32 flow's max |flow|; and
   ``python -m piv_liteflownet_tpu_torch.run -m piv -v 1 --bf16`` on two
   synthetic pairs must write float32 ``.flo`` files.
4. Times: estimate ms/pair (median and p90 of 100 calls, 30 with the conv
   chain; host clock around synchronised calls) and pairs/s, and with CUDA
   events each kernel at its level-1 shape beside its plain version, the one
   PyTorch call that computes the same function where there is one
   (``library_ms``; the port never calls it), and its bound from the bytes
   and operations it needs (``corr49`` also at the level-1 shape of a 256^2
   batch-8 training step, ``backwarp`` also with a random flow beside
   ``F.grid_sample``); ``conv_chain`` at five stacks beside the cuDNN
   chain, with its bound at the 3xTF32 rate (three TF32 products per
   multiply-add, 495/3 TFLOP/s) and at the f32 CUDA-core rate, and its bf16
   form there through the op and alone, beside the f32 form, the bf16 cuDNN
   chain and its bound at the bf16 rate (989 TFLOP/s), with ``ptxas``'s
   registers and spills, and where its time goes: each layer of the v1
   level-1 M, S and R stacks as a one-layer chain at its own shape, beside
   its bf16 bound, and the repacking of its input alone (a zero-layer
   launch; ``chain_layer_split``). bf16 ``estimate``, with cuDNN convs and with the
   chain, right after float32 for the same model and size (1024^2 b1 and
   256^2 b4), and the peak memory of each; ``rgb_warp_norm`` and
   ``backwarp`` (as ``corr49``) also alone into a preallocated output
   (``launch_ms``); the bf16 forms through the op and alone, beside their
   plain version in bf16 and their bound from the bf16 bytes; ``backwarp``'s
   bf16 form alone also with a random 8 px flow and at stride 2, beside its
   float32 form alone and, with ``--parent DIR`` (another checkout's
   ``piv_liteflownet_tpu_torch/csrc``, whose ``backwarp.cu``,
   ``backwarp_bwd.cu``, ``corr49.cu`` and ``corr49_bwd.cu`` are built beside
   this tree's), the parent's bf16 form in turns (tree, parent, parent,
   tree), with ``ptxas``'s lines; ``corr49``'s bf16 and float32 forms alone
   in turns with the parent's (the float32 outputs of the two trees
   bit-equal), the bf16 form's bound counting its products at the bf16
   tensor-core rate (989 TFLOP/s), with ``ptxas``'s lines.
5. Training at 256^2 batch 8 on synthetic particle pairs: one train step
   through the kernels (the training path: the launch counts are set to 0
   just before it and read just after) and one through the plain ops from
   the same weights, their gradients compared (rtol 1e-3, atol 1e-4 *
   max|g| per parameter, the tolerance of tests/test_torch_train.py; TF32
   off); then steps on the one batch, whose loss must be finite and fall,
   timed (median of 25 synchronised steps) with the peak device memory;
   then two epochs of ``Train`` with checkpoints, restored with ``resume``
   and compared with the state in memory; and the backward kernels' times,
   ``backwarp_bwd`` at the level-1 shape at stride 1 (smooth and random
   flow) and stride 2, each beside ``grid_sampler_2d_backward`` on the same
   inputs, its bound and its share of out-of-window tiles; both cost-volume
   kernels at 128^2 batch 8 for 16 to 128 channels, with a line fit that
   splits their time into a per-launch and a per-channel part.
   Then the same check and times (10 steps) for piv v2 with the six-weight
   ``MultiScale``, built with ``conv_impl="chain"``: training never launches
   the forward-only chain. Then bf16 training, ``make_train_step(...,
   compute_dtype=torch.bfloat16)``, for piv v1 and v2 on the same batches:
   one step through the kernels (the bf16 training path: counts set to 0
   just before and read just after; only the ``_bf16`` forms, forward and
   backward, may launch) and one through the plain ops, both held to the
   float32 plain step's loss and gradients (``grad_relation``: the gradient's
   relative L2 error as a whole, in the median parameter and at the worst
   parameter within twice the plain bf16 path's; the loss within twice the
   plain path's error plus 1e-3), the loss falling over the same steps as
   the float32 phase, ms/step (median, p90) and peak memory beside the
   float32 step's; and the two bf16 backward kernels alone beside their
   float32 forms, their plain version in bf16 and their bf16 bound
   (``corr49_bwd``'s at the bf16 tensor-core rate, and in turns with its
   float32 form and, with ``--parent``, the parent's two forms, whose float32
   output must be bit-equal to this tree's);
   ``backwarp_bwd``'s at stride 1 (smooth and random 8 px flow) and stride 2,
   with ``ptxas``'s lines and, with ``--parent``, the parent's bf16 form (its
   int32 boxes preallocated) in turns.

The line before the last is ``{"kernels": [...]}`` (``launches``: per call of
each kernel's own path, the piv v1 estimate for the forward kernels, the
piv v2 chain estimate for ``conv_chain``, the piv v1 train step for the
backward ones, the piv v1 bf16 estimate for the forward ``_bf16`` forms,
the piv v1 bf16 chain estimate for ``conv_chain_bf16``, the piv v1 bf16
train step for the backward ones; ``launches_per_train_step`` of the float32 piv v1 step and
``launches_by_path`` for all twelve C entry points); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result. It needs no argument; ``--parent DIR`` adds the parent's
warp and cost-volume kernels to phases 4 and 5.
"""

from __future__ import annotations

import ctypes
import json
import math
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
TF32_FLOPS_PER_S = 495e12   # H100 SXM dense TF32 tensor-core rate
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core rate
WARP_ATOL = 1e-5
CORR_RTOL = 1e-5
MODEL_ATOL, MODEL_RTOL = 2e-4, 1e-3
BWD_RTOL = 1e-5             # backward kernels: atol 1e-5 * max|plain|
CHAIN_RTOL = 1e-5           # conv_chain: atol 1e-5 * max|plain|
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4  # train step, kernels vs plain ops, per parameter
MAIN_H = MAIN_W = 1024
TRAIN_B, TRAIN_H, TRAIN_W = 8, 256, 256
TRAIN_STEPS = 25  # timed steps (median); 3 more warm up
TRAIN_STEPS_V2 = 10
ESTIMATE_ITERS = 100  # p90 then has ten samples beyond it
CHAIN_ESTIMATE_ITERS = 30


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


def make_flow(kind, b: int, ho: int, wo: int, stride: int, h: int, w: int, seed: int, dev) -> torch.Tensor:
    """A flow ``[b,2,ho,wo]`` of a kind: "smooth" (``smooth_flow``), "zoom" (converging: the frame
    sampled on 0.3 of it, rectangles of the bf16 backward past their candidate cap), "spike" (zero
    but for a 6x6 patch whose pixels all sample one point, an element past its tap cap), or a
    number: uniform random up to that many pixels."""
    if kind == "smooth":
        return smooth_flow(b, ho, wo, dev)
    ys = stride * torch.arange(ho, device=dev, dtype=torch.float32)[:, None]
    xs = stride * torch.arange(wo, device=dev, dtype=torch.float32)[None, :]
    if kind == "zoom":
        return torch.stack([(-0.7 * (xs - w / 2)).expand(ho, wo), (-0.7 * (ys - h / 2)).expand(ho, wo)])[None].repeat(b, 1, 1, 1)
    if kind == "spike":
        flow = torch.zeros((b, 2, ho, wo), device=dev)
        flow[:, 0, 10:16, 10:16] = 20.3 - xs[:, 10:16]
        flow[:, 1, 10:16, 10:16] = 12.3 - ys[10:16]
        return flow
    return uniform((b, 2, ho, wo), seed, dev, -kind, kind)


def flow_name(kind) -> str:
    return f"{kind} flow" if isinstance(kind, str) else f"|flow|<={kind:g}"


# -- phase 2: kernels against their plain versions -------------------------------------

def level_shapes(h: int, w: int):
    """Per pyramid level of PIV-LiteFlowNet-en v1 on an h x w pair: (level, size, channels of M/S)."""
    chans = {1: 64, 2: 64, 3: 64, 4: 96, 5: 128, 6: 192}  # NetC_ext lifts levels 1-2 to 64
    return [(lv, (h >> (lv - 1), w >> (lv - 1)), chans[lv]) for lv in range(1, 7)]


def chain_stack(parts_c, chain, last_k, b, h, w, seed, dev):
    """Random inputs ``[b,c,h,w]`` and weights of a conv stack: 3x3 convs, the last one k x k."""
    g = torch.Generator(device=dev).manual_seed(seed)
    parts = [torch.randn((b, c, h, w), device=dev, generator=g) * 0.5 for c in parts_c]
    weights, biases = [], []
    for i, (cin, cout) in enumerate(chain):
        k = last_k if i == len(chain) - 1 else 3
        weights.append(torch.randn((cout, cin, k, k), device=dev, generator=g) / math.sqrt(k * k * cin))
        biases.append(torch.randn((cout,), device=dev, generator=g) * 0.1)
    return parts, weights, biases


def chain_cases():
    """(name, part channels, chain, last kernel, last_linear, b, h, w) of the stacks checked."""
    from piv_liteflownet_tpu_torch.models.liteflownet import KLAST, m_chain, r_chain, s_chain

    return [
        ("v1 M level 1", [49], m_chain(1), KLAST[1], True, 1, MAIN_H, MAIN_W),
        ("v1 S level 1", [64, 64, 2], s_chain(1, 1), KLAST[1], True, 1, MAIN_H, MAIN_W),
        ("v1 R level 1", [1, 2, 128], r_chain(1), 3, False, 1, MAIN_H, MAIN_W),
        ("v2 M level 2", [49], m_chain(2), KLAST[2], True, 1, MAIN_H // 2, MAIN_W // 2),
        ("v2 S level 2", [64, 64, 2], s_chain(2, 2), KLAST[2], True, 1, MAIN_H // 2, MAIN_W // 2),
        ("v2 S level 6", [192, 192, 2], s_chain(6, 2), KLAST[6], True, 1, 32, 32),
        ("v2 S level 4 odd", [96, 96, 2], s_chain(4, 2), KLAST[4], True, 2, 35, 41),
        ("R level 6 odd", [1, 2, 192], r_chain(6), 3, False, 2, 37, 53),
        ("v1 S level 3 odd", [64, 64, 2], s_chain(3, 1), KLAST[3], True, 2, 123, 77),
    ]


def chain_work(parts_c, weights, b, h, w):
    """(bytes, flops) a conv stack must move and compute: inputs, weights and output once."""
    macs = sum(wt.numel() for wt in weights) * b * h * w
    nbytes = 4 * (b * h * w * (sum(parts_c) + weights[-1].shape[0])
                  + sum(wt.numel() + wt.shape[0] for wt in weights))
    return nbytes, 2 * macs


def check_kernels(dev, ops):
    corr, warp, rgb, chain = ops
    errs = {"corr49": 0.0, "backwarp": 0.0, "rgb_warp_norm": 0.0, "backwarp_bwd": 0.0,
            "corr49_bwd": 0.0, "conv_chain": 0.0}
    failures = []

    def record(name, what, err, tol):
        errs[name] = max(errs[name], err)
        ok = err <= tol
        log(f"  {name:14s} {what:60s} max_abs_err {err:.3e}  tol {tol:.3e}  {'ok' if ok else 'FAIL'}")
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
    # odd widths (the kernels' edge path), maps smaller than the window, one channel, 192 at 8x8
    corr_edge_cases = [(2, 3, 37, 53), (1, 192, 8, 8), (2, 5, 2, 3), (1, 1, 1, 1), (1, 4, 3, 8)]
    corr_cases += corr_edge_cases + [(1, 64, 37, 53), (4, 64, 64, 64)]
    warp_cases += [(2, 5, 37, 53, 1, 30.0), (2, 7, 37, 53, 2, 30.0), (4, 64, 128, 128, 2, 8.0)]
    rgb_cases += [(2, 37, 53, 30.0), (4, 256, 256, 8.0)]

    edge_counter = corr.edge_tile_counter(dev)
    corr_tiles = {"corr49": {"vector": 0, "edge": 0}, "corr49_bwd": {"vector": 0, "edge": 0}}

    def count_corr_tiles(name, b, h, w):
        """Hold the kernel's count of edge-path tiles to ops/correlation.py:tile_plan."""
        plan = corr.tile_plan(b, h, w, backward=name == "corr49_bwd")
        n_edge = int(edge_counter.item())
        corr_tiles[name]["edge"] += n_edge
        corr_tiles[name]["vector"] += plan.n_tiles - n_edge
        if n_edge != (plan.n_tiles if plan.edge else 0):
            failures.append(f"{name} [{b},{h},{w}]: {n_edge} edge-path tiles, the tile rule says "
                            f"{plan.n_tiles if plan.edge else 0}")
        return n_edge, plan.n_tiles

    for b, c, h, w in corr_cases:
        seed += 1
        f1, f2 = randn((b, c, h, w), seed, dev), randn((b, c, h, w), seed + 1000, dev)
        edge_counter.zero_()
        got = corr.corr49(f1, f2)
        torch.cuda.synchronize()
        n_edge, n_tiles = count_corr_tiles("corr49", b, h, w)
        want = corr.corr49_plain(f1, f2)
        tol = CORR_RTOL * float((f1 * f2).abs().mean())
        record("corr49", f"[{b},{c},{h},{w}], {n_edge}/{n_tiles} edge-path tiles",
               float((got - want).abs().max()), tol)
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
    # the level-1 training shape at both strides: a smooth flow (every tile in its window)
    # and a 30 px random flow (tiles out of the window)
    for s in (1, 2):
        bwd_warp_cases += [(TRAIN_B, 64, TRAIN_H, TRAIN_W, s, "smooth"), (TRAIN_B, 64, TRAIN_H, TRAIN_W, s, 30.0)]
    bwd_corr_cases += corr_edge_cases
    counter = warp.out_of_window_counter(dev)
    tiles = {"window": 0, "out of window": 0}
    for b, c, h, w, s, mag in bwd_warp_cases:
        seed += 1
        img = randn((b, c, h, w), seed, dev).requires_grad_()
        ho, wo = warp.out_hw(h, w, s)
        flow = (smooth_flow(b, ho, wo, dev) if mag == "smooth"
                else uniform((b, 2, ho, wo), seed + 1000, dev, -mag, mag)).requires_grad_()
        gout = randn((b, c, ho, wo), seed + 2000, dev)
        counter.zero_()
        warp.backwarp(img, flow, s).backward(gout)
        torch.cuda.synchronize()
        rule = warp.tile_windows(flow.detach(), h, w, s)
        n_out, n_rule = int(counter.item()), int((~rule.fits).sum())
        tiles["out of window"] += n_out
        tiles["window"] += rule.fits.numel() - n_out
        if n_out != n_rule:
            failures.append(f"backwarp_bwd [{b},{c},{h},{w}] stride {s}: {n_out} tiles out of the "
                            f"window, the tile rule says {n_rule}")
        want_img, want_flow = warp.backwarp_bwd_plain(img.detach(), flow.detach(), gout, s)
        err = max(float((img.grad - want_img).abs().max()), float((flow.grad - want_flow).abs().max()))
        tol = BWD_RTOL * max(float(want_img.abs().max()), float(want_flow.abs().max()), 1.0)
        what = f"[{b},{c},{h},{w}] stride {s} " + ("smooth flow" if mag == "smooth" else f"|flow|<={mag:g}")
        record("backwarp_bwd", f"{what}, {n_out}/{rule.fits.numel()} tiles out", err, tol)
        del img, flow, gout, want_img, want_flow, rule
    log(f"  backwarp_bwd tiles over these cases: {tiles} (each count equal to ops/warp.py:tile_windows)")
    if not all(tiles.values()):
        failures.append(f"backwarp_bwd: a path of the kernel never ran: {tiles}")
    for b, c, h, w in bwd_corr_cases:
        seed += 1
        f1 = randn((b, c, h, w), seed, dev).requires_grad_()
        f2 = randn((b, c, h, w), seed + 1000, dev).requires_grad_()
        g = randn((b, 49, h, w), seed + 2000, dev)
        out = corr.corr49(f1, f2)
        torch.cuda.synchronize()
        edge_counter.zero_()
        out.backward(g)
        torch.cuda.synchronize()
        n_edge, n_tiles = count_corr_tiles("corr49_bwd", b, h, w)
        want1, want2 = corr.corr49_bwd_plain(f1.detach(), f2.detach(), g)
        err = max(float((f1.grad - want1).abs().max()), float((f2.grad - want2).abs().max()))
        tol = BWD_RTOL * max(float(want1.abs().max()), float(want2.abs().max()), 1.0)
        record("corr49_bwd", f"[{b},{c},{h},{w}], {n_edge}/{n_tiles} edge-path tiles", err, tol)
        del f1, f2, g, out, want1, want2
    log(f"  cost-volume tiles over these cases: {corr_tiles} (each edge count equal to "
        f"ops/correlation.py:tile_plan)")
    for name, paths_run in corr_tiles.items():
        if not all(paths_run.values()):
            failures.append(f"{name}: a path of the kernel never ran: {paths_run}")
    with torch.no_grad():
        for name, parts_c, stack, last_k, last_linear, b, h, w in chain_cases():
            seed += 1
            parts, weights, biases = chain_stack(parts_c, stack, last_k, b, h, w, seed, dev)
            got = chain.conv_chain(parts, weights, biases, last_linear)
            torch.cuda.synchronize()
            want = chain.conv_chain_plain(parts, weights, biases, last_linear)
            record("conv_chain", f"{name} [{b},{sum(parts_c)},{h},{w}] {len(stack)} convs",
                   float((got - want).abs().max()), CHAIN_RTOL * float(want.abs().max()))
            del parts, weights, biases, got, want
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return errs


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |ref| (ref: bf16 values held in float32)."""
    _, e = torch.frexp(ref.abs())
    return torch.ldexp(torch.ones_like(ref), e - 8)


def check_bf16_kernels(dev, ops):
    """Each kernel's bf16 form against the float32 plain version on the bf16 inputs upcast to
    float32, then rounded to bf16: within one bf16 ulp of that reference plus the float32
    kernel's own tolerance, elementwise."""
    corr, warp, rgb, chain = ops
    bf = torch.bfloat16
    errs = dict.fromkeys(BF16_KERNELS + BF16_BWD_KERNELS, 0.0)
    failures = []

    def hold(name, what, got, want_f32, f32_tol):
        ref = want_f32.to(bf).float()
        err = (got.float() - ref).abs()
        n_bad = int((err > bf16_ulp(ref) + f32_tol).sum())
        errs[name] = max(errs[name], float(err.max()))
        ok = n_bad == 0 and got.dtype == bf
        log(f"  {name:18s} {what:56s} max_abs_err {float(err.max()):.3e}, {n_bad} beyond 1 ulp "
            f"+ {f32_tol:.1e}  {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} {what}")

    seed = 500
    corr_cases, warp_cases, rgb_cases = [], [], []
    for lv, (h, w), c in level_shapes(MAIN_H, MAIN_W):
        s = 2 if lv < 4 else 1
        corr_cases.append((1, c, -(-h // s), -(-w // s), True))
        warp_cases.append((1, c, h, w, 1, 8.0))
        if lv < 6:
            warp_cases.append((1, c, h, w, s, 8.0))
        rgb_cases.append((1, h, w, 8.0))
    # the edge path: odd widths, widths that are a multiple of 4 but not of 8 (a float32 vector
    # launch, a bf16 edge one), maps smaller than the window, a tensor 2 bytes off 16
    corr_cases += [(2, 3, 37, 53, True), (1, 192, 8, 8, True), (2, 5, 2, 3, True), (1, 1, 1, 1, True),
                   (1, 4, 3, 12, True), (1, 64, 64, 36, True), (1, 8, 16, 32, False)]
    # the staged path's edges: odd widths and channel counts, widths a multiple of 8, a tensor 2 bytes
    # off 16 (every tile direct), steep flows (tiles too wide to stage)
    warp_cases += [(1, 64, MAIN_H, MAIN_W, 1, 30.0), (1, 64, MAIN_H, MAIN_W, 2, 30.0),
                   (2, 5, 37, 53, 1, 30.0), (2, 7, 37, 53, 2, 30.0), (2, 33, 41, 67, 1, 4.0),
                   (2, 33, 40, 64, 1, 3.0), (2, 7, 40, 64, 2, 3.0), (2, 5, 40, 64, 1, "off"),
                   (1, 192, 32, 32, 1, 2.0)]
    rgb_cases += [(2, 37, 53, 30.0), (4, 256, 256, 8.0)]
    edge_counter = corr.edge_tile_counter(dev)
    tiles = {"vector": 0, "edge": 0}
    for b, c, h, w, aligned in corr_cases:
        seed += 1
        n = b * c * h * w
        if aligned:
            f1, f2 = randn((b, c, h, w), seed, dev).to(bf), randn((b, c, h, w), seed + 1000, dev).to(bf)
        else:
            base = randn((2 * n + 1,), seed, dev).to(bf)
            f1, f2 = base[1:1 + n].view(b, c, h, w), base[1 + n:].view(b, c, h, w)
        edge_counter.zero_()
        got = corr.corr49(f1, f2)
        torch.cuda.synchronize()
        plan = corr.tile_plan(b, h, w, aligned=aligned, dtype=bf)
        n_edge = int(edge_counter.item())
        tiles["edge"] += n_edge
        tiles["vector"] += plan.n_tiles - n_edge
        if n_edge != (plan.n_tiles if plan.edge else 0) or corr.uses_edge_path(f1, f2) != plan.edge:
            failures.append(f"corr49_bf16 [{b},{c},{h},{w}]: {n_edge} edge-path tiles, the tile rule "
                            f"says {plan.n_tiles if plan.edge else 0}")
        again = torch.empty_like(got)  # a second launch: bit-equal
        corr._launch(f1, f2, again)
        torch.cuda.synchronize()
        if not torch.equal(again.view(torch.int16), got.view(torch.int16)):
            failures.append(f"corr49_bf16 [{b},{c},{h},{w}]: two launches differ")
        a, bb = f1.float(), f2.float()
        hold("corr49_bf16", f"[{b},{c},{h},{w}]{'' if aligned else ' 2 bytes off'}, {n_edge}/{plan.n_tiles} "
             f"edge-path tiles", got, corr.corr49_plain(a, bb), CORR_RTOL * float((a * bb).abs().mean()))
        del f1, f2, got, a, bb, again
    log(f"  corr49_bf16 tiles over these cases: {tiles} (each edge count equal to "
        f"ops/correlation.py:tile_plan; every case's second launch bit-equal to its first)")
    if not all(tiles.values()):
        failures.append(f"corr49_bf16: a path of the kernel never ran: {tiles}")
    direct_counter = warp.direct_tile_counter(dev)
    warp_tiles = {"staged": 0, "direct": 0}
    for b, c, h, w, s, mag in warp_cases:
        seed += 1
        off = mag == "off"  # the map 2 bytes off 16, 3 px flow
        if off:
            img = randn((b * c * h * w + 1,), seed, dev).to(bf)[1:].view(b, c, h, w)
        else:
            img = randn((b, c, h, w), seed, dev).to(bf)
        ho, wo = warp.out_hw(h, w, s)
        flow = uniform((b, 2, ho, wo), seed + 1000, dev, -3.0 if off else -mag, 3.0 if off else mag).to(bf)
        direct_counter.zero_()
        got = warp.backwarp(img, flow, s)
        torch.cuda.synchronize()
        rule = warp.staged_tiles(flow.float(), h, w, s, aligned=not off)
        n_direct = int(direct_counter.item())
        warp_tiles["direct"] += n_direct
        warp_tiles["staged"] += rule.numel() - n_direct
        if n_direct != int(rule.sum()):
            failures.append(f"backwarp_bf16 [{b},{c},{h},{w}] stride {s}: {n_direct} tiles gathered directly, the "
                            f"tile rule says {int(rule.sum())}")
        hold("backwarp_bf16", f"[{b},{c},{h},{w}] stride {s} " + ("2 bytes off, |flow|<=3" if off else f"|flow|<={mag:g}")
             + f", {n_direct}/{rule.numel()} direct", got, warp.backwarp_plain(img.float(), flow.float(), s), WARP_ATOL)
        del img, flow, got
    log(f"  backwarp_bf16 tiles over these cases: {warp_tiles} (each direct count equal to "
        f"ops/warp.py:staged_tiles)")
    if not all(warp_tiles.values()):
        failures.append(f"backwarp_bf16: a path of the kernel never ran: {warp_tiles}")
    for b, h, w, mag in rgb_cases:
        seed += 1
        img1 = uniform((b, 3, h, w), seed, dev, 0, 1).to(bf)
        img2 = uniform((b, 3, h, w), seed + 7, dev, 0, 1).to(bf)
        flow = uniform((b, 2, h, w), seed + 1000, dev, -mag, mag).to(bf)
        got = rgb.rgb_warp_norm(img1, img2, flow)
        torch.cuda.synchronize()
        hold("rgb_warp_norm_bf16", f"[{b},3,{h},{w}] |flow|<={mag:g}", got,
             rgb.rgb_warp_norm_plain(img1.float(), img2.float(), flow.float()), WARP_ATOL)
        del img1, img2, flow, got
    seed = check_bf16_chain(dev, chain, hold, errs, failures, seed)
    seed = check_bf16_backward(dev, ops, hold, failures, seed)
    if failures:
        raise AssertionError(f"bf16 kernels disagree with their references: {failures}")
    return errs


def check_bf16_chain(dev, chain, hold, errs, failures, seed):
    """``conv_chain``'s bf16 form. One conv of k = 1, 3, 5 and 7 on the tensor-core path (40 -> 48
    channels) and on the FFMA path (20 -> 6) at [2,c,123,77], held as ``hold`` holds every bf16
    kernel. Every stack of ``chain_cases`` (the piv v1 level-1 M, S and R stacks of a 1024^2 pair,
    the 6-conv v2 stacks, odd sizes): its error against the float32 kernel on the same bf16 values
    within twice the plain bf16 chain's (which rounds as the kernel does, once per layer, and sums
    in another order)."""
    bf = torch.bfloat16

    def bf16_stack(*args):
        return ([t.to(bf) for t in ts] for ts in chain_stack(*args))

    with torch.no_grad():
        for k in (1, 3, 5, 7):
            for cin, cout in ((40, 48), (20, 6)):
                seed += 1
                parts, weights, biases = bf16_stack([cin], [(cin, cout)], k, 2, 123, 77, seed, dev)
                got = chain.conv_chain(parts, weights, biases, False)
                torch.cuda.synchronize()
                want = chain.conv_chain_plain(*([t.float() for t in ts] for ts in (parts, weights, biases)), False)
                hold("conv_chain_bf16", f"[2,{cin},123,77] one {k}x{k} conv to {cout} "
                     f"({'tensor cores' if cout > 8 else 'FFMA'})", got, want, CHAIN_RTOL * float(want.abs().max()))
        for name, parts_c, stack, last_k, last_linear, b, h, w in chain_cases():
            seed += 1
            parts, weights, biases = bf16_stack(parts_c, stack, last_k, b, h, w, seed, dev)
            got = chain.conv_chain(parts, weights, biases, last_linear)
            torch.cuda.synchronize()
            ref = chain.conv_chain(*([t.float() for t in ts] for ts in (parts, weights, biases)), last_linear)
            plain = chain.conv_chain_plain(parts, weights, biases, last_linear)
            err, plain_err = (float((t.float() - ref).abs().max()) for t in (got, plain))
            errs["conv_chain_bf16"] = max(errs["conv_chain_bf16"], err)
            ok = err <= 2 * plain_err and got.dtype == bf
            what = f"{name} [{b},{sum(parts_c)},{h},{w}] {len(stack)} convs"
            log(f"  {'conv_chain_bf16':18s} {what:56s} vs the f32 kernel {err:.3e}, the plain bf16 chain "
                f"{plain_err:.3e} (max|ref| {float(ref.abs().max()):.3e})  {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"conv_chain_bf16 {what}")
            del parts, weights, biases, got, ref, plain
    return seed


def check_bf16_backward(dev, ops, hold, failures, seed):
    """The bf16 forms of the two backward kernels through autograd, against the float32 plain
    backward on the bf16 inputs upcast (``hold``): ``backwarp_bwd_bf16`` at the level-1 shape of a
    256^2 batch-8 training step at both strides with a smooth and a 30 px random flow, at smaller
    level shapes, at odd sizes and channel counts (5, 7, 33), and with a converging (zoom) and a
    spike flow at both strides, its count of owner rectangles on the slower path held to
    ``owner_rects`` and both paths required, and a second launch bit-equal to the first;
    ``corr49_bwd_bf16`` at the training step's level shapes and at edge shapes (odd widths,
    widths a multiple of 4 but not of 8, maps smaller than the window, a tensor 2 bytes off 16),
    its edge count held to ``tile_plan`` and both paths required."""
    corr, warp, _, _ = ops
    bf = torch.bfloat16
    counter = warp.slow_rect_counter(dev)
    rects = {"fast": 0, "slow": 0}
    warp_cases = [(TRAIN_B, 64, TRAIN_H, TRAIN_W, s, kind) for s in (1, 2) for kind in ("smooth", 30.0)]
    warp_cases += [(TRAIN_B, 64, TRAIN_H // 2, TRAIN_W // 2, 2, 8.0), (TRAIN_B, 96, TRAIN_H // 8, TRAIN_W // 8, 1, 8.0),
                   (2, 5, 37, 53, 1, 30.0), (2, 7, 37, 53, 2, 30.0), (2, 33, 41, 67, 1, 8.0),
                   (2, 33, 41, 67, 2, "smooth"), (2, 5, 40, 70, 1, "zoom"), (1, 7, 64, 96, 2, "zoom"),
                   (2, 33, 40, 70, 1, "spike"), (1, 7, 40, 70, 2, "spike")]
    for b, c, h, w, s, kind in warp_cases:
        seed += 1
        img = randn((b, c, h, w), seed, dev).to(bf).requires_grad_()
        ho, wo = warp.out_hw(h, w, s)
        flow = make_flow(kind, b, ho, wo, s, h, w, seed + 1000, dev).to(bf).requires_grad_()
        gout = randn((b, c, ho, wo), seed + 2000, dev).to(bf)
        counter.zero_()
        warp.backwarp(img, flow, s).backward(gout)
        torch.cuda.synchronize()
        n_slow = int(counter.item())
        rule = warp.owner_rects(flow.detach().float(), h, w, s)
        rects["slow"] += n_slow
        rects["fast"] += rule.slow.numel() - n_slow
        if n_slow != int(rule.slow.sum()):
            failures.append(f"backwarp_bwd_bf16 [{b},{c},{h},{w}] stride {s}: {n_slow} rectangles on the slower "
                            f"path, the owner rule says {int(rule.slow.sum())}")
        g_img, g_flow = torch.empty_like(img), torch.empty_like(flow)  # a second launch: bit-equal
        warp._launch_bwd(img.detach(), flow.detach(), gout, s, g_img, g_flow)
        torch.cuda.synchronize()
        if not (torch.equal(g_img.view(torch.int16), img.grad.view(torch.int16))
                and torch.equal(g_flow.view(torch.int16), flow.grad.view(torch.int16))):
            failures.append(f"backwarp_bwd_bf16 [{b},{c},{h},{w}] stride {s} {flow_name(kind)}: two launches differ")
        want_img, want_flow = warp.backwarp_bwd_plain(img.detach().float(), flow.detach().float(), gout.float(), s)
        tol = BWD_RTOL * max(float(want_img.abs().max()), float(want_flow.abs().max()), 1.0)
        what = f"[{b},{c},{h},{w}] stride {s} {flow_name(kind)}, {n_slow}/{rule.slow.numel()} slow"
        hold("backwarp_bwd_bf16", "g_img " + what, img.grad, want_img, tol)
        hold("backwarp_bwd_bf16", "g_flow " + what, flow.grad, want_flow, tol)
        del img, flow, gout, want_img, want_flow, rule, g_img, g_flow
    log(f"  backwarp_bwd_bf16 owner rectangles over these cases: {rects} (each slow count equal to "
        f"ops/warp.py:owner_rects; every case's second launch bit-equal to its first)")
    if not all(rects.values()):
        failures.append(f"backwarp_bwd_bf16: a path of the kernel never ran: {rects}")
    edge_counter = corr.edge_tile_counter(dev)
    corr_tiles = {"vector": 0, "edge": 0}
    corr_cases = []
    for lv, (h, w), c in level_shapes(TRAIN_H, TRAIN_W):
        s = 2 if lv < 4 else 1
        corr_cases.append((TRAIN_B, c, -(-h // s), -(-w // s), True))
    corr_cases += [(2, 3, 37, 53, True), (1, 192, 8, 8, True), (2, 5, 2, 3, True), (1, 1, 1, 1, True),
                   (1, 4, 3, 12, True), (2, 64, 64, 36, True), (1, 8, 16, 32, False)]
    for b, c, h, w, aligned in corr_cases:
        seed += 1
        n = b * c * h * w
        if aligned:
            f1, f2 = randn((b, c, h, w), seed, dev).to(bf), randn((b, c, h, w), seed + 1000, dev).to(bf)
        else:
            base = randn((2 * n + 1,), seed, dev).to(bf)
            f1, f2 = base[1:1 + n].view(b, c, h, w), base[1 + n:].view(b, c, h, w)
        f1, f2 = f1.requires_grad_(), f2.requires_grad_()
        g = randn((b, 49, h, w), seed + 2000, dev).to(bf)
        out = corr.corr49(f1, f2)
        torch.cuda.synchronize()
        edge_counter.zero_()
        out.backward(g)
        torch.cuda.synchronize()
        plan = corr.tile_plan(b, h, w, backward=True, aligned=aligned, dtype=bf)
        n_edge = int(edge_counter.item())
        corr_tiles["edge"] += n_edge
        corr_tiles["vector"] += plan.n_tiles - n_edge
        if n_edge != (plan.n_tiles if plan.edge else 0) or corr.uses_edge_path(f1, f2, g) != plan.edge:
            failures.append(f"corr49_bwd_bf16 [{b},{c},{h},{w}]: {n_edge} edge-path tiles, the tile rule "
                            f"says {plan.n_tiles if plan.edge else 0}")
        g_f1, g_f2 = torch.empty_like(f1), torch.empty_like(f2)  # a second launch: bit-equal
        corr._launch_bwd(f1.detach(), f2.detach(), g, g_f1, g_f2)
        torch.cuda.synchronize()
        if not (torch.equal(g_f1.view(torch.int16), f1.grad.view(torch.int16))
                and torch.equal(g_f2.view(torch.int16), f2.grad.view(torch.int16))):
            failures.append(f"corr49_bwd_bf16 [{b},{c},{h},{w}]: two launches differ")
        want1, want2 = corr.corr49_bwd_plain(f1.detach().float(), f2.detach().float(), g.float())
        tol = BWD_RTOL * max(float(want1.abs().max()), float(want2.abs().max()), 1.0)
        what = f"[{b},{c},{h},{w}]{'' if aligned else ' 2 bytes off'}, {n_edge}/{plan.n_tiles} edge"
        hold("corr49_bwd_bf16", "g_f1 " + what, f1.grad, want1, tol)
        hold("corr49_bwd_bf16", "g_f2 " + what, f2.grad, want2, tol)
        del f1, f2, g, out, want1, want2, g_f1, g_f2
    log(f"  corr49_bwd_bf16 tiles over these cases: {corr_tiles} (each edge count equal to "
        f"ops/correlation.py:tile_plan; every case's second launch bit-equal to its first)")
    if not all(corr_tiles.values()):
        failures.append(f"corr49_bwd_bf16: a path of the kernel never ran: {corr_tiles}")
    return seed


# -- phase 3: the slice end to end -------------------------------------------------------

def close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=MODEL_ATOL, rtol=MODEL_RTOL, msg=lambda m: f"{what}: {m}")
    return err


# (family, version, conv_impl, b, h, w, seed, launches of corr49/backwarp/rgb_warp_norm/conv_chain,
#  held to the CPU model); the chain takes the M, S and R stacks of every level of >= 32x32
SLICE_CASES = [
    ("piv", 1, "cudnn", 1, MAIN_H, MAIN_W, 1, (6, 11, 6, 0), False),  # the first slice's main path
    ("piv", 1, "cudnn", 4, 256, 256, 2, (6, 11, 6, 0), False),
    ("piv", 1, "cudnn", 1, 250, 300, 3, (6, 11, 6, 0), True),
    ("piv", 2, "cudnn", 1, MAIN_H, MAIN_W, 4, (5, 9, 5, 0), False),
    ("piv", 2, "cudnn", 4, 256, 256, 5, (5, 9, 5, 0), False),
    ("piv", 2, "cudnn", 1, 250, 300, 6, (5, 9, 5, 0), True),
    ("hui", 2, "cudnn", 1, MAIN_H, MAIN_W, 7, (4, 7, 4, 0), False),
    ("hui", 2, "cudnn", 1, 250, 300, 8, (4, 7, 4, 0), True),
    ("piv", 1, "chain", 1, MAIN_H, MAIN_W, 9, (6, 11, 6, 18), False),
    ("piv", 1, "chain", 4, 256, 256, 10, (6, 11, 6, 12), False),
    ("piv", 1, "chain", 1, 250, 300, 11, (6, 11, 6, 12), True),
    ("piv", 2, "chain", 1, MAIN_H, MAIN_W, 12, (5, 9, 5, 15), False),  # this slice's main path
    ("piv", 2, "chain", 4, 256, 256, 13, (5, 9, 5, 9), False),
    ("piv", 2, "chain", 1, 250, 300, 14, (5, 9, 5, 9), True),
    ("hui", 2, "chain", 1, MAIN_H, MAIN_W, 15, (4, 7, 4, 12), False),
]
FWD_KERNELS = ("corr49", "backwarp", "rgb_warp_norm", "conv_chain")
BF16_KERNELS = ("corr49_bf16", "backwarp_bf16", "rgb_warp_norm_bf16", "conv_chain_bf16")
BF16_BWD_KERNELS = ("backwarp_bwd_bf16", "corr49_bwd_bf16")
PATH_V1 = "estimate piv v1 1024^2 b1"
PATH_V2_CHAIN = "estimate piv v2 conv_impl=chain 1024^2 b1"


def build_model(family, version, conv_impl, device=None):
    from piv_liteflownet_tpu_torch import hui_liteflownet, piv_liteflownet

    fn = piv_liteflownet if family == "piv" else hui_liteflownet
    return fn(version=version, seed=0, device=device, conv_impl=conv_impl)


def run_slice(dev, ops):
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS
    from piv_liteflownet_tpu_torch.utils.flow_io import read_flow, write_flow
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    models, paths = {}, {}
    for family, version, conv_impl, b, h, w, seed, expected, on_cpu in SLICE_CASES:
        key = (family, version, conv_impl)
        if key not in models:
            models[key] = build_model(*key)
        model = models[key]
        what = f"{family} v{version} {conv_impl} b{b} {h}x{w}"
        im1, im2 = particle_pair(b, h, w, seed)
        t1, t2 = torch.from_numpy(im1).to(dev), torch.from_numpy(im2).to(dev)
        torch.cuda.synchronize()
        reset_counts(ops)
        flow = estimate(model, t1, t2, tensor=True)
        torch.cuda.synchronize()
        all_counts = read_counts(ops)
        counts = tuple(all_counts[k] for k in FWD_KERNELS)
        if (key, b, h) == (("piv", 1, "cudnn"), 1, MAIN_H):
            paths[PATH_V1] = all_counts
        if (key, b, h) == (("piv", 2, "chain"), 1, MAIN_H):
            paths[PATH_V2_CHAIN] = all_counts
        if counts != expected or any(v for k, v in all_counts.items() if k.endswith("_bf16")):
            raise AssertionError(f"{what}: launches {all_counts} per forward, expected {expected} "
                                 f"and no bf16 form")
        if tuple(flow.shape) != (b, h, w, 2) or not bool(torch.isfinite(flow).all()):
            raise AssertionError(f"{what}: bad flow, shape {tuple(flow.shape)}")
        plain = estimate(model, t1, t2, tensor=True, ops=PLAIN_OPS)
        err = close(flow, plain, f"{what} kernels vs plain ops")
        line = (f"  estimate {what}: launches corr49/backwarp/rgb_warp_norm/conv_chain = {counts}, "
                f"|flow| mean {float(flow.norm(dim=-1).mean()):.4f}, max_abs_err vs plain ops {err:.3e}")
        if on_cpu:
            ref = estimate(build_model(*key, device="cpu"), im1, im2, tensor=True)
            line += f", vs CPU plain path {close(flow.cpu(), ref, f'{what} card vs CPU'):.3e}"
        log(line)
        if (key, h, w) == (("piv", 1, "cudnn"), 250, 300):
            with tempfile.TemporaryDirectory() as tmp:
                path = str(Path(tmp) / "pair_out.flo")
                arr = flow[0].cpu().numpy()
                write_flow(arr, path)
                if not np.array_equal(read_flow(path), arr):
                    raise AssertionError(".flo round trip changed the flow")
            log("  .flo round trip: ok")
            check_tf32_repair(model, t1, t2, ref, flow)
    return {"paths": paths, "models": models}


def check_tf32_repair(model, t1, t2, cpu_ref, f32_flow):
    """``estimate`` under torch's default flags (cuDNN TF32 on) runs its convs in float32: it is
    held to the CPU plain path and to the call with TF32 off. Beside it, the TF32 error that an
    unpinned eval forward under those flags makes."""
    from piv_liteflownet_tpu_torch.inference import estimate, to_nchw
    from piv_liteflownet_tpu_torch.ops.nn import f32_convs
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        flow = estimate(model, t1, t2, tensor=True)
        torch.cuda.synchronize()
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError("estimate did not restore cuDNN's TF32 flag")
        err_cpu = close(flow.cpu(), cpu_ref, "estimate under default flags vs CPU")
        err_off = float((flow - f32_flow).abs().max())
        im1, im2 = particle_pair(1, MAIN_H, MAIN_W, seed=16)
        x1, x2 = to_nchw(im1, t1.device), to_nchw(im2, t1.device)
        with torch.no_grad():
            tf32 = model(x1, x2)
            with f32_convs():
                f32 = model(x1, x2)
    if torch.backends.cudnn.allow_tf32:
        raise AssertionError("cudnn.flags did not restore TF32 off")
    if err_off > MODEL_ATOL:
        raise AssertionError(f"estimate under default flags differs from TF32 off by {err_off:.3e}")
    log(f"  TF32 repair: estimate b1 250x300 under torch's default flags (cuDNN TF32 on) vs CPU "
        f"plain path {err_cpu:.3e}, vs the same call with TF32 off {err_off:.3e}; an unpinned "
        f"eval forward at {MAIN_H}x{MAIN_W} with TF32 on vs float32: max abs "
        f"{float((tf32 - f32).abs().max()):.3e} (max|flow| {float(f32.abs().max()):.3e})")


# (family, version, conv_impl, b, h, w, seed, launches of the bf16 forms of corr49/backwarp/
#  rgb_warp_norm/conv_chain, held to the CPU model); every float32 form must launch 0 times
BF16_CASES = [
    ("piv", 1, "cudnn", 1, MAIN_H, MAIN_W, 31, (6, 11, 6, 0), False),  # the main path of bf16 inference
    ("piv", 2, "cudnn", 1, MAIN_H, MAIN_W, 32, (5, 9, 5, 0), False),
    ("hui", 2, "cudnn", 1, MAIN_H, MAIN_W, 33, (4, 7, 4, 0), False),
    ("piv", 1, "cudnn", 4, 256, 256, 34, (6, 11, 6, 0), False),
    ("piv", 1, "cudnn", 1, 250, 300, 35, (6, 11, 6, 0), True),
    ("piv", 2, "cudnn", 1, 250, 300, 36, (5, 9, 5, 0), True),
    ("piv", 1, "chain", 1, MAIN_H, MAIN_W, 40, (6, 11, 6, 18), False),  # this slice's main path
    ("piv", 1, "chain", 4, 256, 256, 41, (6, 11, 6, 12), False),
    ("piv", 1, "chain", 1, 250, 300, 42, (6, 11, 6, 12), True),
    ("piv", 2, "chain", 1, MAIN_H, MAIN_W, 43, (5, 9, 5, 15), False),
    ("piv", 2, "chain", 4, 256, 256, 44, (5, 9, 5, 9), False),
    ("piv", 2, "chain", 1, 250, 300, 45, (5, 9, 5, 9), True),
    ("hui", 2, "chain", 1, MAIN_H, MAIN_W, 46, (4, 7, 4, 12), False),
    ("hui", 2, "chain", 4, 256, 256, 47, (4, 7, 4, 6), False),
    ("hui", 2, "chain", 1, 250, 300, 48, (4, 7, 4, 6), True),
]
BF16_FLOW_TOL = 0.03  # of the float32 flow's max |flow|, as tests/test_torch_bf16.py
PATH_V1_BF16 = "estimate piv v1 bf16 1024^2 b1"
PATH_V1_BF16_CHAIN = "estimate piv v1 bf16 conv_impl=chain 1024^2 b1"


def run_bf16_slice(dev, ops, f32_models):
    """bf16 inference end to end: ``estimate`` of each model cast to bfloat16, with cuDNN convs and
    with the conv chain, with the launch counts set to 0 just before it and read just after (only
    the bf16 forms may launch); its flow held to the float32 flow of the same weights and
    ``conv_impl`` on the same pair, to the bf16 plain ops on the card, with the chain also to the
    bf16 cuDNN path, and, at 250x300, to the bf16 CPU path; and the ``run`` CLI with ``--bf16``
    writes float32 ``.flo`` files."""
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    bf = torch.bfloat16
    models, paths = {}, {}
    for family, version, conv_impl, b, h, w, seed, expected, on_cpu in BF16_CASES:
        key = (family, version, conv_impl)
        if key not in models:
            models[key] = build_model(*key).to(bf)
        model = models[key]
        what = f"{family} v{version} bf16 {conv_impl} b{b} {h}x{w}"
        im1, im2 = particle_pair(b, h, w, seed)
        t1, t2 = torch.from_numpy(im1).to(dev), torch.from_numpy(im2).to(dev)
        torch.cuda.synchronize()
        reset_counts(ops)
        flow = estimate(model, t1, t2, tensor=True)
        torch.cuda.synchronize()
        counts = read_counts(ops)
        if (key, b, h) == (("piv", 1, "cudnn"), 1, MAIN_H):
            paths[PATH_V1_BF16] = counts
        if (key, b, h) == (("piv", 1, "chain"), 1, MAIN_H):
            paths[PATH_V1_BF16_CHAIN] = counts
        got = tuple(counts[k] for k in BF16_KERNELS)
        f32_launched = {k: v for k, v in counts.items() if not k.endswith("_bf16") and v}
        if got != expected or f32_launched:
            raise AssertionError(f"{what}: launches {counts}, expected bf16 {expected} and no float32 form")
        if (flow.dtype != bf or tuple(flow.shape) != (b, h, w, 2)
                or not bool(torch.isfinite(flow).all())):
            raise AssertionError(f"{what}: bad flow, {flow.dtype} {tuple(flow.shape)}")
        ref = estimate(f32_models[key], t1, t2, tensor=True)
        tol = BF16_FLOW_TOL * float(ref.abs().max())
        errs = {"vs float32": float((flow.float() - ref).abs().max())}
        errs["vs bf16 plain ops"] = float((flow - estimate(model, t1, t2, tensor=True, ops=PLAIN_OPS))
                                          .float().abs().max())
        if conv_impl == "chain":
            cudnn = models[family, version, "cudnn"]  # an earlier case of BF16_CASES
            errs["vs bf16 cuDNN"] = float((flow - estimate(cudnn, t1, t2, tensor=True)).float().abs().max())
        if on_cpu:
            cpu = estimate(build_model(*key, device="cpu").to(bf), im1, im2, tensor=True)
            errs["vs bf16 CPU plain path"] = float((flow.float().cpu() - cpu.float()).abs().max())
        log(f"  estimate {what}: launches corr49/backwarp/rgb_warp_norm/conv_chain_bf16 = {got}, float32 "
            f"forms 0; max|flow| f32 {float(ref.abs().max()):.4e}, "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {tol:.3e})")
        if max(errs.values()) > tol:
            raise AssertionError(f"{what}: {errs} beyond {tol:.3e}")
        del flow, ref, t1, t2
    run_cli_bf16(models["piv", 1, "cudnn"])
    return {"paths": paths, "models": models}


def run_cli_bf16(model) -> None:
    """``python -m piv_liteflownet_tpu_torch.run -m piv -v 1 --bf16`` on a directory of two
    synthetic 256^2 pairs: float32 .flo files holding bf16 values, which agree with the bf16
    ``estimate`` of ``model`` (piv v1, the same seeded weights) on the frames read back."""
    from PIL import Image

    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.run import load_image
    from piv_liteflownet_tpu_torch.utils.flow_io import read_flow
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    with tempfile.TemporaryDirectory() as tmp:
        indir, outdir = Path(tmp) / "pairs", Path(tmp) / "out"
        indir.mkdir()
        im1, im2 = particle_pair(2, 256, 256, seed=38)
        for i in range(2):
            for tag, im in (("img1", im1[i]), ("img2", im2[i])):
                Image.fromarray((im * 255).round().astype(np.uint8)).save(indir / f"p{i:02d}_{tag}.png")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "piv_liteflownet_tpu_torch.run", "-m", "piv", "-v", "1",
                               "--bf16", "-p", "-i", str(indir), "-o", str(outdir)],
                              capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parent)
        if proc.returncode != 0:
            raise AssertionError(f"run --bf16 failed:\n{proc.stdout}\n{proc.stderr}")
        flodir = outdir / "PIV-LiteFlowNet-en" / "pairs" / "flow"
        flos = sorted(flodir.iterdir())
        if [f.name for f in flos] != ["p00_img1_out.flo", "p01_img1_out.flo"]:
            raise AssertionError(f"run --bf16 wrote {flos}")
        for f in flos:
            flow = read_flow(str(f))
            if f.stat().st_size != 12 + 4 * 256 * 256 * 2 or not np.isfinite(flow).all():
                raise AssertionError(f"{f.name}: not a finite float32 256x256 flow")
            if not torch.equal(torch.from_numpy(flow).to(torch.bfloat16).float(), torch.from_numpy(flow)):
                raise AssertionError(f"{f.name}: values are not bf16 values")
            stem = f.name[:-len("_img1_out.flo")]
            want = estimate(model, load_image(str(indir / f"{stem}_img1.png")),
                            load_image(str(indir / f"{stem}_img2.png")))
            if np.abs(flow - want).max() > BF16_FLOW_TOL * max(float(np.abs(want).max()), 1e-30):
                raise AssertionError(f"{f.name}: differs from the bf16 estimate of the same frames")
        log(f"  run -m piv -v 1 --bf16 on 2 pairs: {[f.name for f in flos]}, float32 .flo holding bf16 "
            f"values ({time.perf_counter() - t0:.1f} s, process start and kernel load included); "
            f"it printed: {' | '.join(proc.stdout.strip().splitlines()[:3])}")


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


def in_turns(timer, fns: dict) -> dict:
    """Each of ``fns`` timed by ``timer`` twice, in turns: in the order given, then reversed
    (name -> [ms, ms])."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(timer(fns[name]))
    return times


def parent_call(parent, name: str, dev, *args):
    """A call of the parent tree's C entry point ``name`` (see ``warp_library``)."""
    return lambda: call_entry(parent, name, dev, *args)


def pixel_grid(flow: torch.Tensor, h: int, w: int, stride: int = 1) -> torch.Tensor:
    """grid_sample grid (align_corners=True) on an h x w map that samples at (s*x + u, s*y + v)."""
    xs = stride * torch.arange(flow.shape[3], device=flow.device, dtype=torch.float32) + flow[:, 0]
    ys = stride * torch.arange(flow.shape[2], device=flow.device, dtype=torch.float32)[:, None] + flow[:, 1]
    return torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], dim=-1)


def bound_ms(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def time_estimate(fn, b: int, what: str, card: str, iters: int = ESTIMATE_ITERS) -> None:
    """Median and p90 of ``iters`` synchronised calls of ``fn`` (one batch of ``b`` pairs)."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    med, p90 = np.percentile(samples, [50, 90])
    log(f"  estimate {what}: {med / b:.3f} ms/pair median, p90 {p90 / b:.3f} "
        f"({len(samples)} calls), {1e3 * b / med:.2f} pairs/s ({card})")
    return med / b


def peak_memory(dev, fn) -> float:
    """Peak device memory (GiB) of one call of ``fn`` beyond what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated(dev) - base) / 2**30


def cudnn_chain(parts, weights, biases, last_linear):
    """A conv stack as the model's cuDNN path runs it: the parts concatenated, then each conv and
    LeakyReLU in the operands' dtype."""
    x = torch.cat(parts, 1)
    for i, (wt, bs) in enumerate(zip(weights, biases)):
        x = F.conv2d(x, wt, bs, 1, wt.shape[2] // 2)
        if i < len(weights) - 1 or not last_linear:
            x = F.leaky_relu(x, 0.1)
    return x


def ptxas_lines(build_log: str, source: str) -> list:
    """The register, stack and spill lines ``ptxas -v`` printed for ``source``'s kernels."""
    lines, keep = [], False
    for line in build_log.splitlines():
        if line.startswith("=="):
            keep = line == f"== {source}"
        elif keep and any(k in line for k in ("entry function", "registers", "spill")):
            lines.append(line.strip())
    return lines


def warp_library(csrc: Path, out: Path, sources=("backwarp.cu", "backwarp_bwd.cu"), signatures=None):
    """``sources`` of ``csrc`` (another tree's ``piv_liteflownet_tpu_torch/csrc``, or a variant
    of this one's) built with ``kernels/build.py``'s flags, all at once, into ``out/libwarp.so``,
    its entry points bound with ``build.SIGNATURES`` updated by ``signatures``: (library, ptxas
    lines by source)."""
    from piv_liteflownet_tpu_torch.kernels import build

    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = [(src, subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-I", str(csrc), "-c", str(csrc / src), "-o",
                                     str(out / (src + ".o"))], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)) for src in sources]
    logs = []
    for src, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / src}:\n{text}")
        logs.append(f"== {src}\n{text}")
    lib_path = out / "libwarp.so"
    subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", *(str(out / (src + ".o")) for src in sources), "-o",
                    str(lib_path)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in dict(build.SIGNATURES, **(signatures or {})).items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    log_text = "\n".join(logs)
    return lib, {src: ptxas_lines(log_text, src) for src in sources}


def call_entry(lib, name: str, dev, *args) -> None:
    """One call of ``lib``'s C entry point ``name`` on ``dev``'s current stream; raise on an error."""
    rc = getattr(lib, name)(*args, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def repack_alone(chain, parts, scratch) -> None:
    """The bf16 form's repacking of ``parts`` into ``scratch[1]`` alone: a zero-layer launch of
    ``pivk_conv_chain_bf16`` (raises where the library does not take one). ``scratch`` is
    ``[2, b*h*w*stride + 8]`` bf16: the launch's grid barrier counter follows ``scratch[1]``'s
    pixels."""
    from piv_liteflownet_tpu_torch import kernels

    b, _, h, w = parts[0].shape
    part_ptrs = (ctypes.c_void_p * len(parts))(*(p.data_ptr() for p in parts))
    part_c = (ctypes.c_int * len(parts))(*(p.shape[1] for p in parts))
    kernels.launch("pivk_conv_chain_bf16", "conv_chain", parts[0].device, ctypes.addressof(part_ptrs),
                   ctypes.addressof(part_c), len(parts), None, 0, None, scratch[0].data_ptr(),
                   scratch[1].data_ptr(), None, b, h, w, 0)


def chain_layer_split(dev, chain, timer, card, tag: str = "") -> list:
    """Where the bf16 chain's time goes: each layer of the piv v1 level-1 M, S and R stacks of a
    1024^2 pair as a one-layer ``conv_chain`` at its own shape (its input: the stack's parts for
    layer 0, one ``[1,cin,1024,1024]`` part after), alone into a preallocated output, beside its
    bf16 bound; and the repacking of the same input alone, as a zero-layer launch where the
    library takes one (``repack_ms``, else None) and as a 1x1 conv to 2 channels on the FFMA path
    (``repack_1x1_ms``). A one-layer chain repacks its input first and writes its output NCHW, as a
    stack's last layer does; ``layer_ms`` is its time less ``repack_ms`` (or the 1x1 proxy)."""
    bf = torch.bfloat16
    rows = []
    with torch.no_grad():
        for i, (name, parts_c, stack, last_k, last_linear, b, h, w) in enumerate(chain_cases()[:3]):
            _, weights, biases = chain_stack(parts_c, stack, last_k, b, h, w, 60 + i, dev)
            for j, (wt, bs) in enumerate(zip(weights, biases)):
                cin, cout, k = wt.shape[1], wt.shape[0], wt.shape[2]
                widths = parts_c if j == 0 else [cin]
                parts = [(randn((b, c, h, w), 70 + 10 * i + j, dev) * 0.5).to(bf) for c in widths]
                wb, bb = wt.to(bf), bs.to(bf)
                out = torch.empty((b, cout, h, w), device=dev, dtype=bf)
                ms = timer(lambda: chain._launch(parts, [wb], [bb], False, out), iters=10)
                w2 = (randn((2, cin, 1, 1), 90 + j, dev) / math.sqrt(cin)).to(bf)
                out2 = torch.empty((b, 2, h, w), device=dev, dtype=bf)
                proxy = timer(lambda: chain._launch(parts, [w2], [bb[:2]], False, out2), iters=10)
                scratch = torch.empty((2, b * h * w * -(-cin // 8) * 8 + 8), device=dev, dtype=bf)
                try:
                    repack = timer(lambda: repack_alone(chain, parts, scratch), iters=10)
                except RuntimeError:
                    repack = None
                macs = cin * cout * k * k * b * h * w
                nbytes = 2 * (b * h * w * (cin + cout) + wt.numel() + cout)
                bound = bound_ms(nbytes, 2 * macs, BF16_FLOPS_PER_S)
                plan = chain.layer_plan([(k, cin, cout)], bf)[0]
                layer = ms - (repack if repack is not None else proxy)
                rows.append(dict(stack=name, layer=j, k=k, cin=cin, cout=cout, bn=plan.bn, smem=plan.smem, ms=ms,
                                 repack_ms=repack, repack_1x1_ms=proxy, layer_ms=layer, bound_ms=bound[0],
                                 bound_by=bound[1]))
                log(f"  conv_chain_bf16 split{tag} {name} layer {j} ({k}x{k} {cin}->{cout}, BN {plan.bn}, "
                    f"{plan.smem} B shared): one-layer chain {ms:.4f} ms; repacking alone "
                    f"{'n/a' if repack is None else f'{repack:.4f}'}, 1x1 to 2 {proxy:.4f}; the layer "
                    f"{layer:.4f} ms against its bf16 bound {bound[0]:.4f} ({bound[1]}, "
                    f"{bound[0] / max(layer, 1e-9):.1%} of it)  ({card})")
                del parts, out, out2, scratch
    return rows


def time_all(dev, ops, models, bf16_models, card, build_log, parent=None):
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    corr, warp, rgb, chain = ops
    bf = torch.bfloat16
    per_pair = {}
    # each bf16 cell right after the float32 cell of the same model and size; "bf16" is the bf16
    # model with cuDNN convs, "bf16 chain" with the conv chain
    cells = [(("piv", 1, "cudnn"), 1, MAIN_H, MAIN_W), (("piv", 1, "bf16"), 1, MAIN_H, MAIN_W),
             (("piv", 1, "cudnn"), 4, 256, 256), (("piv", 1, "bf16"), 4, 256, 256),
             (("piv", 2, "cudnn"), 1, MAIN_H, MAIN_W), (("piv", 2, "bf16"), 1, MAIN_H, MAIN_W),
             (("piv", 2, "cudnn"), 4, 256, 256), (("piv", 2, "bf16"), 4, 256, 256)]
    for version in (1, 2):
        for b, h, w in ((1, MAIN_H, MAIN_W), (4, 256, 256)):
            cells += [(("piv", version, "chain"), b, h, w), (("piv", version, "bf16 chain"), b, h, w)]
    bf16_impl = {"bf16": "cudnn", "bf16 chain": "chain"}
    for (family, version, conv_impl), b, h, w in cells:
        model = (bf16_models[family, version, bf16_impl[conv_impl]] if conv_impl in bf16_impl
                 else models[family, version, conv_impl])
        im1, im2 = particle_pair(b, h, w, seed=10 + b)
        t1, t2 = torch.from_numpy(im1).to(dev), torch.from_numpy(im2).to(dev)
        per_pair[family, version, conv_impl, b, h] = time_estimate(
            lambda: estimate(model, t1, t2, tensor=True), b,
            f"{family} v{version} {conv_impl} {h}x{w} b{b}, inputs and flow on the card",
            card, CHAIN_ESTIMATE_ITERS if "chain" in conv_impl else ESTIMATE_ITERS)
    for version in (1, 2):
        f32_ms, bf16_ms = per_pair["piv", version, "cudnn", 1, MAIN_H], per_pair["piv", version, "bf16", 1, MAIN_H]
        log(f"  estimate piv v{version} {MAIN_H}x{MAIN_W} b1: bf16 {bf16_ms:.3f} against float32 "
            f"{f32_ms:.3f} ms/pair in this call (bf16/f32 {bf16_ms / f32_ms:.3f})  ({card})")
        for b, h in ((1, MAIN_H), (4, 256)):
            chain_ms = per_pair["piv", version, "bf16 chain", b, h]
            log(f"  estimate piv v{version} {h}^2 b{b}: bf16 chain {chain_ms:.3f} ms/pair against bf16 cuDNN "
                f"{per_pair['piv', version, 'bf16', b, h]:.3f} and float32 chain "
                f"{per_pair['piv', version, 'chain', b, h]:.3f} in this call  ({card})")
    # what run.py pays per pair: numpy frames in, numpy flow out
    im1, im2 = particle_pair(1, MAIN_H, MAIN_W, seed=12)
    time_estimate(lambda: estimate(models["piv", 1, "cudnn"], im1[0], im2[0]), 1,
                  f"piv v1 cudnn {MAIN_H}x{MAIN_W} b1, numpy in and out", card)
    t1, t2 = torch.from_numpy(im1).to(dev), torch.from_numpy(im2).to(dev)
    for name, model in (("float32", models["piv", 1, "cudnn"]), ("bf16", bf16_models["piv", 1, "cudnn"]),
                        ("float32 chain", models["piv", 1, "chain"]),
                        ("bf16 chain", bf16_models["piv", 1, "chain"])):
        gib = peak_memory(dev, lambda: estimate(model, t1, t2, tensor=True))
        log(f"  estimate piv v1 {name} {MAIN_H}x{MAIN_W} b1: peak device memory {gib:.3f} GiB beyond "
            f"the weights and inputs  ({card})")

    timer = Timer(dev)
    rows = {}
    # corr49 at level 1: f1, f2 subsampled to 512^2 with 64 channels
    # and at level 1 of a 256^2 batch-8 training step, printed beside it; ms is the op as
    # the path calls it (output allocation and the wrapper's host work included, as the
    # earlier rows were timed), launch_ms the kernel alone into a preallocated output
    corr_cases = []
    for b, c, h, w in ((1, 64, MAIN_H // 2, MAIN_W // 2), (TRAIN_B, 64, TRAIN_H // 2, TRAIN_W // 2)):
        f1, f2 = randn((b, c, h, w), 1, dev), randn((b, c, h, w), 2, dev)
        out = torch.empty((b, 49, h, w), device=dev)
        case = dict(shape=f"[{b},{c},{h},{w}]", ms=timer(lambda: corr.corr49(f1, f2)),
                    launch_ms=timer(lambda: corr._launch(f1, f2, out)),
                    plain_ms=timer(lambda: corr.corr49_plain(f1, f2)),
                    bound=bound_ms(4 * (2 * c + 49) * b * h * w, 2 * 49 * c * b * h * w))
        corr_cases.append(case)
        log(f"  corr49 {case['shape']}: {case['ms']:.4f} ms, kernel alone {case['launch_ms']:.4f} ms, bound "
            f"{case['bound'][0]:.4f} ms ({case['bound'][1]}, {case['bound'][0] / case['launch_ms']:.1%} of it)"
            f"  ({card})")
        del f1, f2, out
    rows["corr49"] = dict(corr_cases[0], library_ms=None, cases=[
        {k: (v[0] if k == "bound" else v) for k, v in case.items()} for case in corr_cases])
    # backwarp at level 1: the NetE-S warp of a 64-channel 1024^2 map
    b, c, h, w = 1, 64, MAIN_H, MAIN_W
    img, flow = randn((b, c, h, w), 3, dev), smooth_flow(b, h, w, dev)
    grid = pixel_grid(flow, h, w)
    out = torch.empty_like(img)
    rows["backwarp"] = dict(
        ms=timer(lambda: warp.backwarp(img, flow)), launch_ms=timer(lambda: warp._launch(img, flow, 1, out)),
        plain_ms=timer(lambda: warp.backwarp_plain(img, flow)),
        library_ms=timer(lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                               align_corners=True)),
        shape=f"[{b},{c},{h},{w}] stride 1",
        bound=bound_ms(4 * (2 * c + 2) * b * h * w, 8 * c * b * h * w))
    # the same warp with an independent random flow per pixel (uncoalesced taps)
    flow_r = uniform((b, 2, h, w), 4, dev, -8, 8)
    grid_r = pixel_grid(flow_r, h, w)
    random_case = dict(shape=f"[{b},{c},{h},{w}] stride 1", flow="random |flow|<=8",
                       ms=timer(lambda: warp.backwarp(img, flow_r)),
                       library_ms=timer(lambda: F.grid_sample(img, grid_r, mode="bilinear", padding_mode="zeros",
                                                              align_corners=True)))
    rows["backwarp"]["cases"] = [random_case]
    log(f"  backwarp [1,64,{h},{w}] stride 1, random |flow|<=8: {random_case['ms']:.4f} ms, grid_sample "
        f"{random_case['library_ms']:.4f} ms (kernel/library {random_case['ms'] / random_case['library_ms']:.3f})"
        f"  ({card})")
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
    norm = torch.empty((b, 1, h, w), device=dev)
    rows["rgb_warp_norm"] = dict(
        ms=timer(lambda: rgb.rgb_warp_norm(img1, img2, flow)),
        launch_ms=timer(lambda: rgb._launch(img1, img2, flow, norm)),
        plain_ms=timer(lambda: rgb.rgb_warp_norm_plain(img1, img2, flow)),
        library_ms=timer(lambda: F.grid_sample(img2, grid, mode="bilinear", padding_mode="zeros",
                                               align_corners=True)),
        shape=f"[{b},3,{h},{w}]",
        bound=bound_ms(4 * (3 + 3 + 2 + 1) * b * h * w, 27 * b * h * w))
    del img, img1, img2, flow, grid, flow_r, grid_r, flow2, out, norm
    rows.update(time_bf16_kernels(dev, ops, timer, card, rows, build_log, parent))
    # conv_chain at the piv v1 level-1 M, S and R stacks of a 1024^2 pair (the S stack is the
    # row) and the 6-conv v2 M and S stacks at level 2, each beside the cuDNN chain (its plain
    # version); the bound at the 3xTF32 rate (three TF32 products per multiply-add) and at the
    # f32 CUDA-core rate of the kernel before the tensor cores
    cases, cases_bf16 = [], []
    with torch.no_grad():
        for i, (name, parts_c, stack, last_k, last_linear, b, h, w) in enumerate(chain_cases()[:5]):
            parts, weights, biases = chain_stack(parts_c, stack, last_k, b, h, w, 40 + i, dev)
            ms = timer(lambda: chain.conv_chain(parts, weights, biases, last_linear), iters=10)
            plain_ms = timer(lambda: chain.conv_chain_plain(parts, weights, biases, last_linear), iters=10)
            nbytes, flops = chain_work(parts_c, weights, b, h, w)
            bound = bound_ms(nbytes, 3 * flops, TF32_FLOPS_PER_S)
            bound_f32 = bound_ms(nbytes, flops)
            shape = f"[{b},{sum(parts_c)},{h},{w}] {name}"
            cases.append(dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                              bound_f32_ms=bound_f32[0], flops=flops))
            if name == "v1 S level 1":
                rows["conv_chain"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, shape=shape,
                                          bound=bound, bound_f32_ms=bound_f32[0], cases=cases,
                                          ptxas=ptxas_lines(build_log, "conv_chain.cu"))
            log(f"  conv_chain     {shape:26s} {ms:.4f} ms  cuDNN chain {plain_ms:.4f} ms "
                f"(kernel/cuDNN {ms / plain_ms:.3f})  3xTF32 bound {bound[0]:.4f} ms ({bound[1]}), "
                f"{bound[0] / ms:.1%} of it; f32 bound {bound_f32[0]:.4f} ms, {bound_f32[0] / ms:.1%} "
                f"of it  ({card})")
            # the bf16 form on the same values rounded to bf16: through the op, alone into a
            # preallocated output, its plain version, the model's bf16 cuDNN convs, and the bound
            # at the bf16 rate; beside it the repacking of the parts (a proxy: the same transpose
            # as one PyTorch copy, and its bytes)
            pb, wb, bb = ([t.to(bf) for t in ts] for ts in (parts, weights, biases))
            out = torch.empty((b, wb[-1].shape[0], h, w), device=dev, dtype=bf)
            cin = sum(parts_c)
            case = dict(shape=shape, ms=timer(lambda: chain.conv_chain(pb, wb, bb, last_linear), iters=10),
                        launch_ms=timer(lambda: chain._launch(pb, wb, bb, last_linear, out), iters=10),
                        f32_ms=ms, plain_ms=timer(lambda: chain.conv_chain_plain(pb, wb, bb, last_linear), iters=10),
                        cudnn_ms=timer(lambda: cudnn_chain(pb, wb, bb, last_linear), iters=10),
                        repack_proxy_ms=timer(lambda: torch.cat(pb, 1).permute(0, 2, 3, 1).contiguous(), iters=10),
                        repack_bound_ms=2 * b * h * w * (cin + -(-cin // 8) * 8) / HBM_BYTES_PER_S * 1e3,
                        bound=bound_ms(nbytes / 2, flops, BF16_FLOPS_PER_S), flops=flops)
            cases_bf16.append(case)
            if name == "v1 S level 1":
                rows["conv_chain_bf16"] = dict(case, library_ms=None, cases=cases_bf16,
                                               ptxas=rows["conv_chain"]["ptxas"])
            log(f"  conv_chain_bf16 {shape:25s} {case['ms']:.4f} ms, alone {case['launch_ms']:.4f} ms; f32 form "
                f"{ms:.4f}, bf16 cuDNN chain {case['cudnn_ms']:.4f}, plain bf16 {case['plain_ms']:.4f}; bf16 "
                f"bound {case['bound'][0]:.4f} ms ({case['bound'][1]}), {case['bound'][0] / case['launch_ms']:.1%} "
                f"of it; repacking the parts: proxy {case['repack_proxy_ms']:.4f} ms, bytes "
                f"{case['repack_bound_ms']:.4f} ms  ({card})")
            del parts, weights, biases, pb, wb, bb, out
    for case in cases_bf16:
        case["bound"] = case["bound"][0]
    rows["conv_chain_bf16"]["layer_split"] = chain_layer_split(dev, chain, timer, card)
    for name, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        alone = (f", kernel alone {r['launch_ms']:.4f} ms ({r['bound'][0] / r['launch_ms']:.1%} of the bound)"
                 if "launch_ms" in r else "")
        log(f"  {name:18s} {r['shape']:26s} {r['ms']:.4f} ms{alone}  plain {r['plain_ms']:.4f} ms  "
            f"library {lib} ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]})  ({card})")
    return rows


def corr_turns(dev, corr, timer, card, parent, shape, backward: bool) -> dict:
    """The cost-volume kernel (``backward``: its gradient) alone at ``shape``, in bf16 and float32,
    and, given ``parent`` (another tree's kernels, ``warp_library``), the parent's two forms on the
    same inputs, in turns (name -> [ms, ms]). The float32 outputs of the two trees must be bit-equal
    (the float32 forms keep their code); raises otherwise."""
    b, c, h, w = shape
    maps32 = [randn((b, c, h, w), 61, dev), randn((b, c, h, w), 62, dev)]
    if backward:
        maps32.append(randn((b, 49, h, w), 63, dev))
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    fns, outs = {}, {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        ins = [t.to(dtype) for t in maps32]
        if backward:
            mine, theirs = [torch.empty_like(ins[0]) for _ in range(2)], [torch.empty_like(ins[0]) for _ in range(2)]
            fns[f"tree {tag}"] = lambda ins=ins, o=mine: corr._launch_bwd(*ins, *o)
            name, args = f"pivk_corr49_bwd_{tag}", [t.data_ptr() for t in ins + theirs]
        else:
            mine, theirs = [torch.empty((b, 49, h, w), device=dev, dtype=dtype) for _ in range(2)]
            mine, theirs = [mine], [theirs]
            fns[f"tree {tag}"] = lambda ins=ins, o=mine: corr._launch(*ins, *o)
            name, args = f"pivk_corr49_{tag}", [t.data_ptr() for t in ins + theirs]
        if parent is not None:
            fns[f"parent {tag}"] = parent_call(parent, name, dev, *args, counter.data_ptr(), b, c, h, w)
        outs[tag] = (mine, theirs)
    turns = in_turns(timer, fns)
    what = "corr49_bwd" if backward else "corr49"
    line = ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in turns.items())
    log(f"  {what} {list(shape)} alone, in turns: {line} ms  ({card})")
    if parent is not None:
        mine, theirs = outs["f32"]
        if not all(torch.equal(x, y) for x, y in zip(mine, theirs)):
            raise AssertionError(f"{what}: the float32 form's output differs from the parent's")
        log(f"  {what} float32 output bit-equal to the parent's")
    return turns


def time_bf16_kernels(dev, ops, timer, card, f32_rows, build_log, parent=None):
    """The bf16 forms at their level-1 shapes of a 1024^2 pair: through the op (``ms``), alone
    into a preallocated output (``launch_ms``), the plain version in bf16, and the bound from the
    bf16 bytes. No single PyTorch call computes their function: ``F.grid_sample`` on a bf16 map
    takes a bf16 grid, whose normalised coordinates are coarser than a pixel at this size (its
    time is printed, as a call of another function). ``backwarp_bf16`` also alone with a random
    8 px flow and at stride 2, beside the float32 form alone on the same values, with ``ptxas``'s
    lines for its source, and, given ``parent`` (another tree's warp kernels, ``warp_library``),
    beside the parent's bf16 form alone, in turns."""
    corr, warp, rgb, _ = ops
    bf = torch.bfloat16
    rows = {}
    b, c, h, w = 1, 64, MAIN_H // 2, MAIN_W // 2
    f1, f2 = randn((b, c, h, w), 1, dev).to(bf), randn((b, c, h, w), 2, dev).to(bf)
    out = torch.empty((b, 49, h, w), device=dev, dtype=bf)
    turns = corr_turns(dev, corr, timer, card, parent, (b, c, h, w), backward=False)
    rows["corr49_bf16"] = dict(
        shape=f"[{b},{c},{h},{w}]", ms=timer(lambda: corr.corr49(f1, f2)),
        launch_ms=float(np.median(turns["tree bf16"])), turns_ms=turns["tree bf16"],
        parent_launch_ms=turns.get("parent bf16"), f32_ms=float(np.median(turns["tree f32"])),
        plain_ms=timer(lambda: corr.corr49_plain(f1, f2)), library_ms=None,
        # bf16 products summed in f32: tensor-core work (K6 bf16's rate)
        bound=bound_ms(2 * (2 * c + 49) * b * h * w, 2 * 49 * c * b * h * w, BF16_FLOPS_PER_S),
        ptxas=ptxas_lines(build_log, "corr49_bf16.cu"))
    log(f"  corr49_bf16 {rows['corr49_bf16']['shape']}: bound {rows['corr49_bf16']['bound'][0]:.4f} ms "
        f"({rows['corr49_bf16']['bound'][1]}, {rows['corr49_bf16']['bound'][0] / rows['corr49_bf16']['launch_ms']:.1%} "
        f"of it alone)  ({card})")
    del f1, f2, out
    b, c, h, w = 1, 64, MAIN_H, MAIN_W
    img32 = randn((b, c, h, w), 3, dev)
    img = img32.to(bf)
    parent_counter = torch.zeros(1, dtype=torch.int32, device=dev)
    cases = []
    for s, kind in ((1, "smooth"), (1, 8.0), (2, "smooth")):
        ho, wo = warp.out_hw(h, w, s)
        flow32 = make_flow(kind, b, ho, wo, s, h, w, 4, dev)
        flow = flow32.to(bf)
        out, out32 = torch.empty((b, c, ho, wo), device=dev, dtype=bf), torch.empty((b, c, ho, wo), device=dev)
        fns = {"tree": lambda: warp._launch(img, flow, s, out)}
        if parent is not None:
            fns["parent"] = parent_call(parent, "pivk_backwarp_bf16", dev, img.data_ptr(), flow.data_ptr(),
                                        out.data_ptr(), parent_counter.data_ptr(), b, c, h, w, ho, wo, s)
        turns = in_turns(timer, fns)
        case = dict(shape=f"[{b},{c},{h},{w}] stride {s}", flow=flow_name(kind), launch_ms=float(np.median(turns["tree"])),
                    f32_launch_ms=timer(lambda: warp._launch(img32, flow32, s, out32)),
                    parent_launch_ms=turns.get("parent"), turns_ms=turns["tree"],
                    bound=bound_ms(2 * (c * h * w + (c + 2) * ho * wo) * b, 8 * c * b * ho * wo))
        parent_txt = (f", parent's bf16 form {turns['parent'][0]:.4f} / {turns['parent'][1]:.4f} against "
                      f"{turns['tree'][0]:.4f} / {turns['tree'][1]:.4f} in turns" if parent is not None else "")
        log(f"  backwarp_bf16 {case['shape']} {case['flow']}: {case['launch_ms']:.4f} ms alone, float32 form alone "
            f"{case['f32_launch_ms']:.4f}{parent_txt}; bound {case['bound'][0]:.4f} ms ({case['bound'][1]}, "
            f"{case['bound'][0] / case['launch_ms']:.1%} of it)  ({card})")
        if s == 1 and kind == "smooth":
            rows["backwarp_bf16"] = dict(
                shape=case["shape"], ms=timer(lambda: warp.backwarp(img, flow)), launch_ms=case["launch_ms"],
                plain_ms=timer(lambda: warp.backwarp_plain(img, flow)), library_ms=None, bound=case["bound"],
                f32_ms=f32_rows["backwarp"]["launch_ms"], parent_launch_ms=case["parent_launch_ms"],
                ptxas=ptxas_lines(build_log, "backwarp.cu"))
        cases.append({k: (v[0] if k == "bound" else v) for k, v in case.items()})
        del flow, flow32, out, out32
    rows["backwarp_bf16"]["cases"] = cases
    flow = smooth_flow(b, h, w, dev).to(bf)
    grid = pixel_grid(flow.float(), h, w).to(bf)
    gs = timer(lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=True))
    log(f"  (F.grid_sample on the bf16 map with a bf16 grid, another function: {gs:.4f} ms  ({card}))")
    del img, img32, flow, grid
    b, h, w = 1, MAIN_H, MAIN_W
    img1, img2 = uniform((b, 3, h, w), 6, dev, 0, 1).to(bf), uniform((b, 3, h, w), 7, dev, 0, 1).to(bf)
    flow = smooth_flow(b, h, w, dev).to(bf)
    norm = torch.empty((b, 1, h, w), device=dev, dtype=bf)
    rows["rgb_warp_norm_bf16"] = dict(
        shape=f"[{b},3,{h},{w}]", ms=timer(lambda: rgb.rgb_warp_norm(img1, img2, flow)),
        launch_ms=timer(lambda: rgb._launch(img1, img2, flow, norm)),
        plain_ms=timer(lambda: rgb.rgb_warp_norm_plain(img1, img2, flow)), library_ms=None,
        bound=bound_ms(2 * (3 + 3 + 2 + 1) * b * h * w, 27 * b * h * w))
    return rows


# -- phase 5: training -------------------------------------------------------------------------

def reset_counts(ops) -> None:
    corr, warp, rgb, chain = ops
    corr.launches = warp.launches = rgb.launches = chain.launches = 0
    corr.bwd_launches = warp.bwd_launches = 0
    corr.bf16_launches = warp.bf16_launches = rgb.bf16_launches = chain.bf16_launches = 0
    corr.bwd_bf16_launches = warp.bwd_bf16_launches = 0


def read_counts(ops) -> dict:
    """Launches per C entry point: the float32 forms, then the bf16 forms."""
    corr, warp, rgb, chain = ops
    return {"corr49": corr.launches, "backwarp": warp.launches, "rgb_warp_norm": rgb.launches,
            "conv_chain": chain.launches, "corr49_bwd": corr.bwd_launches,
            "backwarp_bwd": warp.bwd_launches, "corr49_bf16": corr.bf16_launches,
            "backwarp_bf16": warp.bf16_launches, "rgb_warp_norm_bf16": rgb.bf16_launches,
            "backwarp_bwd_bf16": warp.bwd_bf16_launches, "corr49_bwd_bf16": corr.bwd_bf16_launches,
            "conv_chain_bf16": chain.bf16_launches}


def steps_on_one_batch(dev, step, state, batch, steps: int):
    """3 warm-up steps, then ``steps`` synchronised steps timed on the host clock, all on one
    batch: (state, the loss of every step, ms of each timed step, peak device memory of the
    timed steps)."""
    losses = []
    for _ in range(3):
        state, metrics = step(state, *batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    samples = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, *batch)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    return state, losses, samples, torch.cuda.max_memory_allocated(dev)


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
    expected = {"corr49": 6, "backwarp": 11, "rgb_warp_norm": 6, "conv_chain": 0, "corr49_bwd": 6,
                "backwarp_bwd": 11, **dict.fromkeys(BF16_KERNELS + BF16_BWD_KERNELS, 0)}
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
    plain_grads = {n: p.grad.clone() for n, p in plain_state.model.named_parameters()}
    del plain_state, plain_step, grads_k
    log(f"  train step {TRAIN_H}x{TRAIN_W} b{TRAIN_B}: launches {counts}; loss kernels {loss_k:.6f} plain {loss_p:.6f}; "
        f"grads within tolerance, worst max|dg|/max|g| {worst:.3e} ({worst_name})")

    # repeated steps on the one batch: finite, falling loss; ms/step
    state, losses, samples, peak = steps_on_one_batch(dev, step, state, batch, TRAIN_STEPS)
    losses.insert(0, loss_k)
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
    return {"launches": counts, "ms_step": med, "p90": p90, "peak": peak, "loss": loss_p,
            "plain_grads": plain_grads}


def run_training_v2(dev, ops, card):
    """One piv v2 train step with the six-weight MultiScale through the kernels against one
    through the plain ops; launches 5/9/5 + 5/9 and no conv_chain (the model is built with
    ``conv_impl="chain"``, which training never takes); ms/step and peak memory."""
    from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, PLAIN_OPS
    from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_train_step
    from piv_liteflownet_tpu_torch.training.loss import v2_multiscale
    from piv_liteflownet_tpu_torch.training.optim import make_optimizer
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    shift = (2.5, -1.5)
    im1, im2 = particle_pair(TRAIN_B, TRAIN_H, TRAIN_W, seed=21, shift=shift)
    target = np.empty((TRAIN_B, TRAIN_H, TRAIN_W, 2), np.float32)
    target[...] = shift
    batch = tuple(torch.from_numpy(a).to(dev) for a in (im1, im2, target))

    def build(ops_):
        model = build_model("piv", 2, "chain")
        opt = make_optimizer(model, model.cfg.lowest_level)
        return TrainState(model, opt), make_train_step(model.cfg, v2_multiscale(), opt, ops=ops_)

    state, step = build(KERNEL_OPS)
    torch.cuda.synchronize()
    reset_counts(ops)
    state, metrics = step(state, *batch)
    torch.cuda.synchronize()
    counts = read_counts(ops)
    expected = {"corr49": 5, "backwarp": 9, "rgb_warp_norm": 5, "conv_chain": 0, "corr49_bwd": 5,
                "backwarp_bwd": 9, **dict.fromkeys(BF16_KERNELS + BF16_BWD_KERNELS, 0)}
    if counts != expected:
        raise AssertionError(f"piv v2 train step launches {counts}, expected {expected}")
    grads_k = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    plain_state, plain_step = build(PLAIN_OPS)
    _, plain_metrics = plain_step(plain_state, *batch)
    torch.cuda.synchronize()
    worst = 0.0
    for n, p in plain_state.model.named_parameters():
        g = p.grad
        torch.testing.assert_close(grads_k[n], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(g.abs().max()), msg=lambda m: f"{n}: {m}")
        worst = max(worst, float((grads_k[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30))
    loss_k, loss_p = float(metrics["loss"]), float(plain_metrics["loss"])
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise AssertionError(f"piv v2 train loss kernels {loss_k} vs plain ops {loss_p}")
    plain_grads = {n: p.grad.clone() for n, p in plain_state.model.named_parameters()}
    del plain_state, plain_step, grads_k
    state, losses, samples, peak = steps_on_one_batch(dev, step, state, batch, TRAIN_STEPS_V2)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite piv v2 training loss: {losses}")
    med, p90 = np.percentile(samples, [50, 90])
    log(f"  piv v2 train step {TRAIN_H}x{TRAIN_W} b{TRAIN_B} (six-weight MultiScale): launches {counts}; "
        f"loss kernels {loss_k:.6f} plain {loss_p:.6f}; grads within tolerance, worst max|dg|/max|g| "
        f"{worst:.3e}; loss after {4 + TRAIN_STEPS_V2} steps {losses[-1]:.6f}")
    log(f"  piv v2 train step {TRAIN_H}x{TRAIN_W} b{TRAIN_B}: {med:.3f} ms/step median, p90 {p90:.3f} "
        f"({TRAIN_STEPS_V2} steps), {1e3 * TRAIN_B / med:.2f} samples/s; peak memory "
        f"{peak / 2**30:.3f} GiB ({card})")
    return {"launches": counts, "ms_step": med, "p90": p90, "peak": peak, "loss": loss_p,
            "plain_grads": plain_grads}


PATH_TRAIN_V1_BF16 = "train step piv v1 256^2 b8 bf16"


def run_training_bf16(dev, ops, card, version, f32):
    """The bf16 train step (``compute_dtype=torch.bfloat16``) of piv v1 (piv loss) or v2
    (six-weight MultiScale) at 256^2 b8 on the batch of the float32 phase: one step through the
    kernels (counts set to 0 just before and read just after: only the ``_bf16`` forms, forward
    and backward), one through the plain ops from the same weights, both held to the float32
    plain step's loss and gradients (``grad_relation``); then steps on the one batch, whose loss
    must be finite and fall, timed beside the float32 step, with the peak device memory."""
    from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, PLAIN_OPS
    from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_train_step
    from piv_liteflownet_tpu_torch.training.loss import piv_loss, v2_multiscale
    from piv_liteflownet_tpu_torch.training.optim import make_optimizer
    from piv_liteflownet_tpu_torch.training.precision import grad_relation
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    shift = (2.5, -1.5)
    im1, im2 = particle_pair(TRAIN_B, TRAIN_H, TRAIN_W, seed=20 if version == 1 else 21, shift=shift)
    target = np.empty((TRAIN_B, TRAIN_H, TRAIN_W, 2), np.float32)
    target[...] = shift
    batch = tuple(torch.from_numpy(a).to(dev) for a in (im1, im2, target))

    def build(ops_):
        model = build_model("piv", version, "cudnn" if version == 1 else "chain")
        opt = make_optimizer(model, model.cfg.lowest_level)
        loss_obj = piv_loss() if version == 1 else v2_multiscale()
        return TrainState(model, opt), make_train_step(model.cfg, loss_obj, opt, ops=ops_,
                                                       compute_dtype=torch.bfloat16)

    state, step = build(KERNEL_OPS)
    torch.cuda.synchronize()
    reset_counts(ops)
    state, metrics = step(state, *batch)
    torch.cuda.synchronize()
    counts = read_counts(ops)
    fwd = (6, 11, 6) if version == 1 else (5, 9, 5)
    expected = dict(dict.fromkeys(counts, 0), corr49_bf16=fwd[0], backwarp_bf16=fwd[1],
                    rgb_warp_norm_bf16=fwd[2], backwarp_bwd_bf16=fwd[1], corr49_bwd_bf16=fwd[0])
    if counts != expected:
        raise AssertionError(f"piv v{version} bf16 train step launches {counts}, expected {expected}")
    grads_k = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    if any(p.dtype != torch.float32 or p.grad.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError("the bf16 step left a parameter or gradient that is not float32")
    plain_state, plain_step = build(PLAIN_OPS)
    _, plain_metrics = plain_step(plain_state, *batch)
    torch.cuda.synchronize()
    grads_p = {n: p.grad.clone() for n, p in plain_state.model.named_parameters()}
    del plain_state, plain_step
    loss_k, loss_p, loss_f32 = float(metrics["loss"]), float(plain_metrics["loss"]), f32["loss"]
    loss_tol = 2 * abs(loss_p - loss_f32) + 1e-3 * abs(loss_f32)
    if not abs(loss_k - loss_f32) <= loss_tol:
        raise AssertionError(f"piv v{version} bf16 loss kernels {loss_k}, plain {loss_p}, float32 {loss_f32}")
    relation = grad_relation(grads_k, grads_p, f32["plain_grads"])
    del grads_k, grads_p
    for part, (err, ref_err, bound) in relation.items():
        if not err <= bound:
            raise AssertionError(f"piv v{version} bf16 gradients, {part}: kernels {err:.4e}, plain ops "
                                 f"{ref_err:.4e}, bound {bound:.4e}")
    log(f"  piv v{version} bf16 train step {TRAIN_H}x{TRAIN_W} b{TRAIN_B}: launches {counts}; loss kernels "
        f"{loss_k:.6f} plain {loss_p:.6f} float32 {loss_f32:.6f} (tol {loss_tol:.3e}); gradient error against "
        f"the float32 plain step, kernels / plain bf16 / bound: "
        + ", ".join(f"{part} {e:.3e} / {r:.3e} / {bd:.3e}" for part, (e, r, bd) in relation.items()))

    steps = TRAIN_STEPS if version == 1 else TRAIN_STEPS_V2
    state, losses, samples, peak = steps_on_one_batch(dev, step, state, batch, steps)
    losses.insert(0, loss_k)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite bf16 training loss: {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"bf16 training loss did not fall on one batch: {losses}")
    med, p90 = np.percentile(samples, [50, 90])
    log(f"  piv v{version} bf16 loss over {len(losses)} steps on one batch: {losses[0]:.6f} -> {losses[-1]:.6f} "
        f"(mean of the last 5 {np.mean(losses[-5:]):.6f})")
    log(f"  piv v{version} bf16 train step {TRAIN_H}x{TRAIN_W} b{TRAIN_B}: {med:.3f} ms/step median, p90 {p90:.3f} "
        f"({steps} steps), {1e3 * TRAIN_B / med:.2f} samples/s; peak memory {peak / 2**30:.3f} GiB; float32 "
        f"step in this call {f32['ms_step']:.3f} ms, p90 {f32['p90']:.3f}, peak {f32['peak'] / 2**30:.3f} GiB "
        f"(bf16/f32 {med / f32['ms_step']:.3f})  ({card})")
    del state, step
    return {"launches": counts, "ms_step": med, "p90": p90, "peak": peak, "relation": relation}


def time_bf16_backward(dev, ops, timer, card, f32_rows, build_log, parent=None):
    """The bf16 forms of the backward kernels alone (the wrapper's ``_launch_bwd``, as the float32
    rows) at their level-1 shapes of a 256^2 batch-8 training step, beside the float32 form's time
    in this call, the plain version in bf16, and the bound from the function's bf16 bytes; for
    ``backwarp_bwd_bf16`` at stride 1 with a smooth and a random 8 px flow and at stride 2, with
    ``ptxas``'s lines for its source and, given ``parent`` (another tree's warp kernels,
    ``warp_library``), beside the parent's bf16 form alone (its int32 boxes preallocated),
    in turns. No single PyTorch call computes their function in bf16: ``grid_sampler_2d_backward``
    on a bf16 map takes a bf16 grid, whose normalised coordinates are coarser than a pixel at 256."""
    corr, warp, _, _ = ops
    bf = torch.bfloat16
    rows = {}
    b, c, h, w = TRAIN_B, 64, TRAIN_H, TRAIN_W
    img = randn((b, c, h, w), 31, dev).to(bf)
    g_img = torch.empty_like(img)
    boxes = torch.empty((b, *warp.owner_grid(h, w), 4), device=dev, dtype=torch.int32)
    parent_counter = torch.zeros(1, dtype=torch.int32, device=dev)
    cases = []
    for s, kind in ((1, "smooth"), (1, 8.0), (2, "smooth")):
        ho, wo = warp.out_hw(h, w, s)
        flow = make_flow(kind, b, ho, wo, s, h, w, 33, dev).to(bf)
        gout = randn((b, c, ho, wo), 32 + s, dev).to(bf)
        g_flow = torch.empty_like(flow)
        n_in, n_out, n_flow = b * c * h * w, b * c * ho * wo, b * 2 * ho * wo
        nbytes = 2 * (2 * n_in + n_out + 2 * n_flow)          # img, g_img, gout, flow, g_flow in bf16
        fns = {"tree": lambda: warp._launch_bwd(img, flow, gout, s, g_img, g_flow)}
        if parent is not None:
            fns["parent"] = parent_call(parent, "pivk_backwarp_bwd_bf16", dev, img.data_ptr(), flow.data_ptr(),
                                        gout.data_ptr(), g_img.data_ptr(), g_flow.data_ptr(),
                                        parent_counter.data_ptr(), boxes.data_ptr(), b, c, h, w, ho, wo, s)
        turns = in_turns(timer, fns)
        case = dict(shape=f"[{b},{c},{h},{w}] stride {s}", flow=flow_name(kind), ms=float(np.median(turns["tree"])),
                    turns_ms=turns["tree"], parent_ms=turns.get("parent"), bound=bound_ms(nbytes, 24 * n_out))
        f32_case = next(x for x in f32_rows["backwarp_bwd"]["cases"] if x["shape"] == case["shape"]
                        and x["flow"] == case["flow"])
        case["f32_ms"] = f32_case["ms"]
        if s == 1 and kind == "smooth":
            case["plain_ms"] = timer(lambda: warp.backwarp_bwd_plain(img, flow, gout, s))
            rows["backwarp_bwd_bf16"] = dict(ms=case["ms"], plain_ms=case["plain_ms"], library_ms=None,
                                             shape=case["shape"], bound=case["bound"], f32_ms=case["f32_ms"],
                                             parent_ms=case["parent_ms"],
                                             ptxas=ptxas_lines(build_log, "backwarp_bwd.cu"))
        cases.append(case)
        parent_txt = (f", the parent's bf16 form {turns['parent'][0]:.4f} / {turns['parent'][1]:.4f} against "
                      f"{turns['tree'][0]:.4f} / {turns['tree'][1]:.4f} in turns" if parent is not None else "")
        log(f"  backwarp_bwd_bf16 {case['shape']}, {case['flow']}: {case['ms']:.4f} ms alone, float32 form "
            f"{case['f32_ms']:.4f} ms (bf16/f32 {case['ms'] / case['f32_ms']:.3f}){parent_txt}; bound "
            f"{case['bound'][0]:.4f} ms ({case['bound'][1]}, {case['bound'][0] / case['ms']:.1%} of it)  ({card})")
        del flow, gout, g_flow
    rows["backwarp_bwd_bf16"]["cases"] = [
        {k: (v[0] if k == "bound" else v) for k, v in case.items()} for case in cases]
    del img, g_img, boxes
    b, c, h, w = TRAIN_B, 64, TRAIN_H // 2, TRAIN_W // 2
    f1, f2 = randn((b, c, h, w), 35, dev).to(bf), randn((b, c, h, w), 36, dev).to(bf)
    g = randn((b, 49, h, w), 37, dev).to(bf)
    g_f1, g_f2 = torch.empty_like(f1), torch.empty_like(f2)
    turns = corr_turns(dev, corr, timer, card, parent, (b, c, h, w), backward=True)
    rows["corr49_bwd_bf16"] = dict(
        ms=float(np.median(turns["tree bf16"])), turns_ms=turns["tree bf16"], parent_ms=turns.get("parent bf16"),
        plain_ms=timer(lambda: corr.corr49_bwd_plain(f1, f2, g)), library_ms=None,
        shape=f"[{b},{c},{h},{w}]", f32_ms=f32_rows["corr49_bwd"]["ms"],
        # bf16 products summed in f32: tensor-core work (K6 bf16's rate)
        bound=bound_ms(2 * (4 * c + 49) * b * h * w, 2 * 2 * 49 * c * b * h * w, BF16_FLOPS_PER_S),
        ptxas=ptxas_lines(build_log, "corr49_bwd_bf16.cu"))
    r = rows["corr49_bwd_bf16"]
    log(f"  corr49_bwd_bf16 {r['shape']}: {r['ms']:.4f} ms alone, float32 form {r['f32_ms']:.4f} ms (bf16/f32 "
        f"{r['ms'] / r['f32_ms']:.3f}); bound {r['bound'][0]:.4f} ms ({r['bound'][1]}, "
        f"{r['bound'][0] / r['ms']:.1%} of it)  ({card})")
    del f1, f2, g, g_f1, g_f2
    for name, r in rows.items():
        log(f"  {name:18s} {r['shape']:26s} {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library null  "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})  ({card})")
    return rows


def time_backward(dev, ops, card):
    """Each backward kernel at its level-1 shape of a 256^2 batch-8 training step."""
    corr, warp, _, _ = ops
    timer = Timer(dev)
    rows = {}
    b, c, h, w = TRAIN_B, 64, TRAIN_H, TRAIN_W
    img = randn((b, c, h, w), 31, dev)
    g_img = torch.empty_like(img)
    counter = warp.out_of_window_counter(dev)
    cases = []
    # the level-1 NetE-S warp (stride 1) with a smooth and a random flow, the NetE-M warp (stride 2)
    for s, kind in ((1, "smooth"), (1, 8.0), (2, "smooth")):
        ho, wo = warp.out_hw(h, w, s)
        flow = smooth_flow(b, ho, wo, dev) if kind == "smooth" else uniform((b, 2, ho, wo), 33, dev, -kind, kind)
        gout = randn((b, c, ho, wo), 32 + s, dev)
        g_flow = torch.empty_like(flow)
        grid = pixel_grid(flow, h, w, s)
        counter.zero_()
        warp._launch_bwd(img, flow, gout, s, g_img, g_flow)
        torch.cuda.synchronize()
        n_out, n_tiles = int(counter.item()), warp.tile_windows(flow, h, w, s).fits.numel()
        # each input read once, each output written once
        nbytes = 4 * (2 * b * c * h * w + b * c * ho * wo + 2 * 2 * b * ho * wo)
        case = dict(
            shape=f"[{b},{c},{h},{w}] stride {s}", flow=flow_name(kind),
            ms=timer(lambda: warp._launch_bwd(img, flow, gout, s, g_img, g_flow)),
            library_ms=timer(lambda: torch.ops.aten.grid_sampler_2d_backward(
                gout, img, grid, 0, 0, True, [True, True])),
            bound=bound_ms(nbytes, 24 * b * c * ho * wo), out_of_window_tiles=n_out, tiles=n_tiles)
        if s == 1 and kind == "smooth":
            case["plain_ms"] = timer(lambda: warp.backwarp_bwd_plain(img, flow, gout, s))
            rows["backwarp_bwd"] = dict(ms=case["ms"], plain_ms=case["plain_ms"], library_ms=case["library_ms"],
                                        shape=case["shape"], bound=case["bound"])
        cases.append(case)
        log(f"  backwarp_bwd {case['shape']}, {case['flow']}: {case['ms']:.4f} ms, grid_sampler_2d_backward "
            f"{case['library_ms']:.4f} ms (kernel/library {case['ms'] / case['library_ms']:.3f}), bound "
            f"{case['bound'][0]:.4f} ms ({case['bound'][1]}, {case['bound'][0] / case['ms']:.1%} of it); "
            f"tiles out of the window {n_out}/{n_tiles} ({n_out / n_tiles:.1%})  ({card})")
        del flow, gout, g_flow, grid
    rows["backwarp_bwd"]["cases"] = [
        {k: (v[0] if k == "bound" else v) for k, v in case.items()} for case in cases]
    del img, g_img
    b, c, h, w = TRAIN_B, 64, TRAIN_H // 2, TRAIN_W // 2
    f1, f2, g = randn((b, c, h, w), 35, dev), randn((b, c, h, w), 36, dev), randn((b, 49, h, w), 37, dev)
    g_f1, g_f2 = torch.empty_like(f1), torch.empty_like(f2)
    rows["corr49_bwd"] = dict(
        ms=timer(lambda: corr._launch_bwd(f1, f2, g, g_f1, g_f2)),
        plain_ms=timer(lambda: corr.corr49_bwd_plain(f1, f2, g)), library_ms=None,
        shape=f"[{b},{c},{h},{w}]",
        bound=bound_ms(4 * (4 * c + 49) * b * h * w, 2 * 2 * 49 * c * b * h * w))
    del f1, f2, g, g_f1, g_f2
    rows["corr49_bwd"]["channel_scan"] = corr_channel_scan(dev, corr, timer, card)
    for name, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name:14s} {r['shape']:26s} {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {lib} ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]})  ({card})")
    return rows


def corr_channel_scan(dev, corr, timer, card):
    """Both cost-volume kernels at 128^2 batch 8 for 16 to 128 channels: a least-squares line
    ms = fixed + per_channel * C splits each time into a per-launch part (g's load, the ring's
    start, the tail) and a per-channel part (staging, sums, the backward's stores)."""
    b, h, w = TRAIN_B, TRAIN_H // 2, TRAIN_W // 2
    scan = {"corr49": {}, "corr49_bwd": {}}
    for c in (16, 32, 64, 128):
        f1, f2, g = randn((b, c, h, w), 51, dev), randn((b, c, h, w), 52, dev), randn((b, 49, h, w), 53, dev)
        out, g_f1, g_f2 = torch.empty_like(g), torch.empty_like(f1), torch.empty_like(f2)
        scan["corr49"][c] = timer(lambda: corr._launch(f1, f2, out))
        scan["corr49_bwd"][c] = timer(lambda: corr._launch_bwd(f1, f2, g, g_f1, g_f2))
        del f1, f2, g, out, g_f1, g_f2
    fits = {}
    for name, times in scan.items():
        per_channel, fixed = np.polyfit(list(times), list(times.values()), 1)
        fits[name] = dict(ms=times, fixed_ms=float(fixed), per_channel_ms=float(per_channel))
        log(f"  {name} [{b},C,{h},{w}] for C = {list(times)}: "
            + ", ".join(f"{t:.4f}" for t in times.values())
            + f" ms; fit {fixed:.4f} ms + {1e3 * per_channel:.3f} us per channel  ({card})")
    return fits


#: The parent tree's sources built beside this tree's (its bf16 cost-volume forms live in the
#: float32 forms' sources).
PARENT_SOURCES = ("backwarp.cu", "backwarp_bwd.cu", "corr49.cu", "corr49_bwd.cu")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    parser.add_argument("--parent", type=Path, default=None,
                        help="another checkout's piv_liteflownet_tpu_torch/csrc: its warp and cost-volume "
                             "kernels are built and timed in turns beside this tree's (phases 4 and 5)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr, flush=True)
        return 2
    from piv_liteflownet_tpu_torch.kernels import build
    from piv_liteflownet_tpu_torch.ops import conv_chain, correlation, rgb_warp, warp

    # the kernels' plain versions call cuDNN directly: full float32 for them too
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
        if any(key in line for key in ("entry function", "registers", "spill")) or line.startswith("=="):
            log(f"    {line.strip()}")
    build.load()
    parent = None
    if args.parent is not None:
        t_parent = time.perf_counter()
        parent, parent_ptxas = warp_library(args.parent.resolve(), build.BUILD_DIR.parent / "parent_warps",
                                            PARENT_SOURCES)
        log(f"  the parent's warp and cost-volume kernels from {args.parent}: built in "
            f"{time.perf_counter() - t_parent:.2f} s")
        for src, lines in parent_ptxas.items():
            for line in lines:
                log(f"    parent {src}: {line}")

    ops = (correlation, warp, rgb_warp, conv_chain)
    log("phase 2: kernels against their plain versions")
    errs = check_kernels(dev, ops)
    errs.update(check_bf16_kernels(dev, ops))
    log(f"  ({time.perf_counter() - t_start:.1f} s)")

    log("phase 3: estimate end to end")
    sl = run_slice(dev, ops)
    log("  bf16 inference:")
    sl_bf16 = run_bf16_slice(dev, ops, sl["models"])
    log(f"  ({time.perf_counter() - t_start:.1f} s)")

    log("phase 4: times")
    rows = time_all(dev, ops, sl.pop("models"), sl_bf16.pop("models"), card, res.log, parent)
    log(f"  ({time.perf_counter() - t_start:.1f} s)")

    log("phase 5: training")
    tr = run_training(dev, ops, card)
    tr2 = run_training_v2(dev, ops, card)
    log("  bf16 training:")
    tr_bf16 = run_training_bf16(dev, ops, card, 1, tr)
    run_training_bf16(dev, ops, card, 2, tr2)
    del tr["plain_grads"], tr2["plain_grads"]
    rows.update(time_backward(dev, ops, card))
    rows.update(time_bf16_backward(dev, ops, Timer(dev), card, rows, res.log, parent))

    sources = {"corr49": "corr49.cu", "backwarp": "backwarp.cu", "rgb_warp_norm": "rgb_warp_norm.cu",
               "conv_chain": "conv_chain.cu", "backwarp_bwd": "backwarp_bwd.cu",
               "corr49_bwd": "corr49_bwd.cu", "corr49_bf16": "corr49_bf16.cu", "backwarp_bf16": "backwarp.cu",
               "rgb_warp_norm_bf16": "rgb_warp_norm.cu", "backwarp_bwd_bf16": "backwarp_bwd.cu",
               "corr49_bwd_bf16": "corr49_bwd_bf16.cu", "conv_chain_bf16": "conv_chain.cu"}
    replaces = {
        "corr49": "piv_liteflownet_tpu/ops/pallas_corr.py:66,162",
        "backwarp": "piv_liteflownet_tpu/ops/pallas_feat_warp.py:115",
        "rgb_warp_norm": "piv_liteflownet_tpu/ops/pallas_rgb_warp.py:119",
        "conv_chain": "piv_liteflownet_tpu/ops/pallas_conv.py:63",
        "backwarp_bwd": "piv_liteflownet_tpu/ops/pallas_warp_vjp.py:119",
        # no TPU kernel: JAX takes the XLA VJP of the shift-stack there
        "corr49_bwd": "piv_liteflownet_tpu/ops/correlation.py:85",
        # the bf16 forms of the same TPU kernels (their output in the input's dtype)
        "corr49_bf16": "piv_liteflownet_tpu/ops/pallas_corr.py:66,162",
        "backwarp_bf16": "piv_liteflownet_tpu/ops/pallas_feat_warp.py:115",
        "rgb_warp_norm_bf16": "piv_liteflownet_tpu/ops/pallas_rgb_warp.py:119",
        # the bf16 backward: K5 in g's dtype, and the XLA VJP of the bf16 shift-stack
        "backwarp_bwd_bf16": "piv_liteflownet_tpu/ops/pallas_warp_vjp.py:119",
        "corr49_bwd_bf16": "piv_liteflownet_tpu/ops/correlation.py:85",
        "conv_chain_bf16": "piv_liteflownet_tpu/ops/pallas_conv.py:63",
    }
    paths = dict(sl["paths"], **sl_bf16["paths"])
    paths["train step piv v1 256^2 b8"] = tr["launches"]
    paths["train step piv v2 256^2 b8"] = tr2["launches"]
    paths[PATH_TRAIN_V1_BF16] = tr_bf16["launches"]
    # each kernel's own path: where its launches are counted
    own = {"corr49": PATH_V1, "backwarp": PATH_V1, "rgb_warp_norm": PATH_V1,
           "conv_chain": PATH_V2_CHAIN, "backwarp_bwd": "train step piv v1 256^2 b8",
           "corr49_bwd": "train step piv v1 256^2 b8", "corr49_bf16": PATH_V1_BF16,
           "backwarp_bf16": PATH_V1_BF16, "rgb_warp_norm_bf16": PATH_V1_BF16,
           "backwarp_bwd_bf16": PATH_TRAIN_V1_BF16, "corr49_bwd_bf16": PATH_TRAIN_V1_BF16,
           "conv_chain_bf16": PATH_V1_BF16_CHAIN}
    kernels = [dict(
        name=name, route="cuda", source=f"piv_liteflownet_tpu_torch/csrc/{sources[name]}",
        replaces=replaces[name], launches=paths[own[name]][name],
        launches_per_train_step=tr["launches"][name],
        launches_by_path={p: counts.get(name, 0) for p, counts in paths.items()},
        max_abs_err=errs[name], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
        bound_by=r["bound"][1], library_ms=r["library_ms"],
        **{k: r[k] for k in ("launch_ms", "bound_f32_ms", "f32_ms", "parent_ms", "parent_launch_ms", "turns_ms", "cudnn_ms",
                             "repack_proxy_ms", "repack_bound_ms", "ptxas", "cases", "channel_scan",
                             "layer_split") if k in r})
        for name, r in rows.items()]
    if len(kernels) != len(sources) or any(k["launches"] == 0 for k in kernels):
        raise AssertionError(f"a kernel never launched on its path: {paths}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
