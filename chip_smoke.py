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
``make_optimizer``, ``make_train_step``, ``Train``, ``resume``; the data path
and ``python -m piv_liteflownet_tpu_torch.trainer``'s ``main``; ``run``,
``evaluate`` and the pack CLI's ``main``; ``make_train_step(remat=True)``,
Lion/Lamb/Yogi/Novograd, ``utils/profiling.trace``, ``postpro``,
``stereo_cal`` and ``stereo_run``) at full width with seeded random weights
and the tracked trained ones, in nine phases; each raises on failure, and
then the script exits non-zero without the final line.

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
   ``corr49`` and ``backwarp`` at the same level shapes,
   flows of up to 30 px at both strides, and the cost volume's edge path
   (widths not a multiple of 8, a tensor 2 bytes off 16; its tile count
   held to ``tile_plan`` and both paths required): each held to the
   float32 plain version on the bf16 inputs upcast to float32, then rounded
   to bf16, within one bf16 ulp of that reference plus the float32 kernel's
   own tolerance, elementwise, and a second launch of the cost volume's bf16
   form bit-equal to the first; ``backwarp``'s bf16 form also at odd widths and
   channel counts (5, 7, 33, 192), widths a multiple of 8 and a tensor 2 bytes
   off 16, its count of tiles that gathered directly held to
   ``ops/warp.py:staged_tiles`` and both of its paths required. Both forms of
   ``backwarp`` also on slabs (``SLAB_CASES``: an image taller than the output
   rows, which start at its row ``row0``, as the halo warp and its fallback
   give it), at both strides, held as above. Then, the
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
   layer, as the kernel and the TPU kernel do). Then both forms of
   ``rgb_warp_norm`` (``RGB_CASES``) at the level shapes of a 1024^2 pair
   with a random 8 px flow, a smooth flow, widths not a multiple of 4 or
   of 2, tensors one and two elements off 16 bytes, a steep flow past the
   float32 form's windows, a flow that leaves the map, NaN, huge and
   infinite flows: the float32 form within atol 1e-5 of the plain version,
   the bf16 form within one bf16 ulp of the rounded float32 plain version
   plus 1e-5, each form's two paths (one and two pixels a lane, by the map's
   size: ``ops/rgb_warp.py:pixels_a_lane``) required; a second launch of
   each bit-equal to the first and, with ``--parent DIR``, the parent's
   kernels' outputs bit-equal to this tree's.
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
   synthetic pairs must write float32 ``.flo`` files. Then the trained
   weights (``run_trained``): piv v1 and v2 with the weights the JAX package
   trained (``work/synth_run*/params_final.npz``) on the four evalset pairs
   (``work/synth_run/evalset``) through float32 cuDNN with the kernels, the
   plain ops on the card, the float32 chain, bf16 cuDNN and bf16 chain, and
   the first pair on the CPU: the AEE and the worst pair's EPE of each beside
   JAX's, and the largest |flow * sf| that reached ``rgb_warp_norm`` at each
   level; kernels vs plain ops, card vs CPU and chain vs cuDNN within 1e-3
   px, the AEEs within ``TRAINED``'s limits of JAX's.
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
   256^2 b4), and the peak memory of each; both forms of ``rgb_warp_norm``
   alone at the level-1 shapes of a 1024^2 pair and of a 256^2 batch-8
   step, with a smooth and a random 8 px flow, in turns with the parent's
   (``--parent``), beside their bound and, for the float32 form,
   ``F.grid_sample`` of the warp half; ``backwarp`` (as ``corr49``) also
   alone into a preallocated output
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
6. The data path and the trainer CLI (``run_data_path``): ``make_dataset_dir``
   renders 32 seeded 384^2 particle pairs with their flows on the card into a
   temporary directory (24 train, 8 val), its render and advection held to
   the CPU's on the same particles (atol 1e-5); the default train
   augmentation of a b8 batch of it on the card held to the CPU's with the
   same drawn factors (atol 1e-5), both under torch's default TF32 flags
   and with every TF32 flag on; then ``trainer.main`` in-process, piv v1 b8
   crop 256^2 with the augmentation inside the step: 2 epochs with the
   launch counts set to 0 just before and read just after (every train-path
   kernel, the float32 eval forward's, no ``conv_chain``), finite losses,
   checkpoints and ``args.txt``; ``--resume`` for epoch 3 against an unbroken
   3-epoch run (the first loss bit for bit, the rest within rel 1e-3). Then
   256 pairs rendered on the card (24 steps an epoch) for 2 timed epochs in
   float32 and 2 with ``--bf16`` (only the ``_bf16`` forms launch). Times:
   the CLI's ms/step (CUDA events around each step), the host's wait for
   each batch and the card's idle time between steps, without each epoch's
   first batch and that batch on its own, beside the same step with the
   augmentation on the run's batches already on the card (no loader), on
   one of them, phase 5's fixed-batch step, and the augmentation alone per
   batch.
7. Ingest and the inference CLIs (``run_ingest``): libpivio built by g++
   from the port's copy of ``pivio.cpp`` (its version, seconds, and whether
   zlib's header was found); its decode of the evalset PNGs bit-equal to
   PIL's values, its ``.flo`` codec bit-equal to ``utils/flow_io.py``, the
   evalset packed into a ``.pivseq`` read back bit-equal. ``evaluate`` in
   process with the trained weights on the evalset: piv v1 float32 and bf16,
   cuDNN and chain, and v2 float32, each AEE within 1e-5 px of
   ``run_trained``'s for the same path and inside its limits of JAX's, the
   launches exactly one estimate's. ``run`` over 64 1024^2 pairs rendered on
   the card and written as 8-bit PNGs, packed by the pack CLI: piv v1 with
   the trained weights in float32 cuDNN and bf16 chain through PIL threads,
   ``--native_io`` and the ``.pivseq``, 3 runs each in turns (pairs/s, the
   card's idle time between batches), the three routes' files bit-equal and
   each run's launches exact, beside ``estimate`` alone on a resident batch
   and each ingest route alone; ``-b 1.0 -c 1.0`` (JAX's names, flows
   bit-equal to the plain path's at batch 1) and ``-b 0.8 1.2`` (file count).
   ``trainer --native_io`` on phase 6's timed directory in float32 and bf16:
   phase 6's launches, the first loss bit-equal to the Python loader's run,
   the rest within rel 1e-3, its step times, waits and idle gaps beside
   phase 6's.
8. Training extras, post-processing and stereo (``run_extras``):
   ``make_train_step(remat=True)`` for piv v1 and v2 at 256^2 b8, float32
   and mixed bf16, beside the step without remat from the same weights on
   phase 5's batch (every forward kernel launched exactly twice as often,
   every backward kernel as often; the loss, and each parameter's gradient
   within 1e-5 of its max |grad|; ms/step median and p90 of 10 in turns; peak
   memory); ``profiling.trace`` around two float32 remat steps (the Chrome
   trace names the port's kernels); two steps of Lion, Lamb, Yogi and
   Novograd on the card against the CPU from the same gradients (atol 1e-6),
   ``trainer --optimizer X`` on phase 6's small directory, ``--resume`` of the
   Novograd run (first loss bit-equal, count carried); ``calc_vorticity`` and
   ``de_vort`` of the trained v1 weights' evalset flows, card against CPU
   (atol 1e-6); ``stereo_cal --clicks`` on two synthetic 1024^2 plates on the
   card and with ``--cpu`` (cross counts equal, centres within 1e-3 px,
   mappings within 0.01 px); ``stereo_run`` with the trained v1 weights,
   ``direct`` and ``manual`` on 8 rendered 1024^2 stereo pairs (within 1e-4
   px; pairs/s beside two estimates alone, the card's idle share between
   estimates), identical views with identity coefficients (W exactly 0, U
   and V ``estimate``'s flow), one 256^2 pair card against ``--cpu`` (1e-3 px),
   and ``reconstruct`` on the card beside the same arithmetic in numpy.
9. Multi-GPU on the one card (``run_multi_gpu``): a mesh of one rank over
   NCCL under the train step and ``estimate`` (bit-equal to the calls
   without a mesh); then two ranks sharing the card over gloo
   (``parallel/mesh.py:spawn``, ``multi_gpu_rank``; NCCL refuses two ranks on
   one device, so NCCL between cards is not shown): the data-parallel step
   of piv v1 at 256^2 b8 (4 rows a rank) in float32 (each gradient within
   1e-5 of its parameter's max |grad| of one process's step on the batch)
   and bf16 (``training/precision.py:grad_relation`` against the float32
   step, as the one-process bf16 step; the worst gradient in bf16 ulps
   printed), each rank launching what one process's step launches; the
   trainer's rank loop for an epoch of phase 6's directory (losses within
   1e-3 relative of one process's, checkpoints from rank 0 only); ``run``'s
   rank function on 8 of phase 7's pairs (files within 1e-4 px); spatial
   ``estimate`` of piv v1 with the trained weights at 2048x1024 in float32
   and bf16, cuDNN and chain (within 1e-4 px of the unsharded call; K1 and
   K4 on slabs, K6 with the chain, no K3; only halo rows exchanged); a
   warp whose flow leaves the halo on one rank alone (every rank gathers,
   the result the unsharded warp's). Times and memory of these ranks are of
   two processes sharing one card, never a multi-card number.
   ``--multi-gpu-only`` runs phases 1 and 9 alone.

The line before the last is ``{"kernels": [...]}`` (``launches``: per call of
each kernel's own path, the piv v1 estimate for the forward kernels, the
piv v2 chain estimate for ``conv_chain``, the piv v1 train step for the
backward ones, the piv v1 bf16 estimate for the forward ``_bf16`` forms,
the piv v1 bf16 chain estimate for ``conv_chain_bf16``, the piv v1 bf16
train step for the backward ones; ``launches_per_train_step`` of the float32 piv v1 step and
``launches_by_path`` for all twelve C entry points, the trainer CLI's runs, ``evaluate``'s and ``run``'s,
the float32 and bf16 piv v1 remat steps, ``stereo_run direct`` and phase 9's paths, per rank, among
them); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result. It needs no argument; ``--parent DIR`` adds the parent's
warp, rgb warp-norm and cost-volume kernels to phases 2, 4 and 5.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
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


#: (b, c, image rows, w, stride, |flow|, output rows, row0) of K4 on slabs (``ops/halo_warp.py``):
#: the halo slab of rank 1 of 2 at level 1 of a 2048x1024 pair (1024 rows and 32 of each
#: neighbour's), at both strides; the gather fallback's whole map, rank 1's rows; odd sizes
SLAB_CASES = [(1, 64, 1088, 1024, 1, 8.0, 1024, 32), (1, 64, 1088, 1024, 2, 8.0, 512, 32),
              (1, 64, 2048, 1024, 1, 40.0, 1024, 1024), (1, 64, 2048, 1024, 2, 40.0, 512, 1024),
              (2, 5, 45, 53, 1, 12.0, 13, 16), (2, 7, 45, 53, 2, 12.0, 7, 16)]


def check_kernels(dev, ops):
    corr, warp, _, chain = ops
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
    corr_cases, warp_cases = [], []
    for lv, (h, w), c in level_shapes(MAIN_H, MAIN_W):
        s = 2 if lv < 4 else 1
        corr_cases.append((1, c, -(-h // s), -(-w // s)))
        warp_cases.append((1, c, h, w, 1, 8.0))          # NetE-S warp
        if lv < 6:
            warp_cases.append((1, c, h, w, s, 8.0))      # NetE-M warp
    # odd widths (the kernels' edge path), maps smaller than the window, one channel, 192 at 8x8
    corr_edge_cases = [(2, 3, 37, 53), (1, 192, 8, 8), (2, 5, 2, 3), (1, 1, 1, 1), (1, 4, 3, 8)]
    corr_cases += corr_edge_cases + [(1, 64, 37, 53), (4, 64, 64, 64)]
    warp_cases += [(2, 5, 37, 53, 1, 30.0), (2, 7, 37, 53, 2, 30.0), (4, 64, 128, 128, 2, 8.0)]

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
    for b, c, h, w, s, mag, ho, row0 in SLAB_CASES:
        seed += 1
        img = randn((b, c, h, w), seed, dev)
        flow = uniform((b, 2, ho, warp.out_hw(h, w, s)[1]), seed + 1000, dev, -mag, mag)
        got = warp.backwarp(img, flow, s, row0)
        torch.cuda.synchronize()
        record("backwarp", f"slab [{b},{c},{h},{w}] stride {s}, {ho} rows from {row0}, |flow|<={mag:g}",
               float((got - warp.backwarp_plain(img, flow, s, row0)).abs().max()), WARP_ATOL)
        del img, flow, got
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
    corr, warp, _, chain = ops
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
    corr_cases, warp_cases = [], []
    for lv, (h, w), c in level_shapes(MAIN_H, MAIN_W):
        s = 2 if lv < 4 else 1
        corr_cases.append((1, c, -(-h // s), -(-w // s), True))
        warp_cases.append((1, c, h, w, 1, 8.0))
        if lv < 6:
            warp_cases.append((1, c, h, w, s, 8.0))
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
    for b, c, h, w, s, mag, ho, row0 in SLAB_CASES:
        seed += 1
        img = randn((b, c, h, w), seed, dev).to(bf)
        flow = uniform((b, 2, ho, warp.out_hw(h, w, s)[1]), seed + 1000, dev, -mag, mag).to(bf)
        direct_counter.zero_()
        got = warp.backwarp(img, flow, s, row0)
        torch.cuda.synchronize()
        rule = warp.staged_tiles(flow.float(), h, w, s, row0=row0)
        n_direct = int(direct_counter.item())
        warp_tiles["direct"] += n_direct
        warp_tiles["staged"] += rule.numel() - n_direct
        if n_direct != int(rule.sum()):
            failures.append(f"backwarp_bf16 slab [{b},{c},{h},{w}] stride {s} from {row0}: {n_direct} tiles "
                            f"gathered directly, the tile rule says {int(rule.sum())}")
        hold("backwarp_bf16", f"slab [{b},{c},{h},{w}] stride {s}, {ho} rows from {row0}, |flow|<={mag:g}, "
             f"{n_direct}/{rule.numel()} direct", got,
             warp.backwarp_plain(img.float(), flow.float(), s, row0), WARP_ATOL)
        del img, flow, got
    log(f"  backwarp_bf16 tiles over these cases: {warp_tiles} (each direct count equal to "
        f"ops/warp.py:staged_tiles)")
    if not all(warp_tiles.values()):
        failures.append(f"backwarp_bf16: a path of the kernel never ran: {warp_tiles}")
    seed = check_bf16_chain(dev, chain, hold, errs, failures, seed)
    seed = check_bf16_backward(dev, ops, hold, failures, seed)
    if failures:
        raise AssertionError(f"bf16 kernels disagree with their references: {failures}")
    return errs


# (b, h, w, flow, elements off 16 bytes) of the rgb warp-norm checks: the level shapes of a 1024^2
# pair with a random 8 px flow, then each path and edge of the two forms
RGB_CASES = [(1, h, w, 8.0, 0) for _, (h, w), _ in level_shapes(MAIN_H, MAIN_W)] + [
    (4, 256, 256, 8.0, 0),
    (1, MAIN_H, MAIN_W, "smooth", 0),
    (2, 37, 53, 30.0, 0),      # ragged rows: the last warp of a row part empty
    (2, 40, 66, 3.0, 0),       # the last warp of a row with two pixels in it
    (2, 40, 64, 3.0, 1),       # each tensor one element off 16 bytes (4 bytes f32, 2 bf16)
    (2, 40, 64, 3.0, 2),       # two elements off (8 bytes f32, 4 bf16)
    (1, 256, 256, 30.0, 0),    # steep: taps far from their pixels
    (2, 48, 80, "shift", 0),   # the frame sampled 0.6 of its width right, 0.4 of its height up
    (1, 33, 130, "nan", 0),    # NaN, huge and infinite sample points among 3 px ones
]


def rgb_inputs(b, h, w, kind, off, dtype, seed, dev):
    """img1, img2 ``[b,3,h,w]`` in [0, 1] and a flow ``[b,2,h,w]`` of ``kind`` (``make_flow``'s, or
    "shift", or "nan"), in ``dtype``, each ``off`` elements past a 16-byte boundary."""
    def place(t):
        t = t.to(dtype)
        if not off:
            return t.contiguous()
        view = torch.empty(t.numel() + 16, device=dev, dtype=dtype)[off:off + t.numel()].view(t.shape)
        return view.copy_(t)

    img1, img2 = uniform((b, 3, h, w), seed, dev, 0, 1), uniform((b, 3, h, w), seed + 7, dev, 0, 1)
    if kind == "shift":
        flow = torch.stack([torch.full((h, w), 0.6 * w), torch.full((h, w), -0.4 * h)]).to(dev)[None].repeat(b, 1, 1, 1)
    elif kind == "nan":
        flow = uniform((b, 2, h, w), seed + 1000, dev, -3, 3)
        flow.view(-1)[::7] = float("nan")
        flow.view(-1)[3::11] = 3e9
        flow.view(-1)[5::13] = -float("inf")
    else:
        flow = make_flow(kind, b, h, w, 1, h, w, seed + 1000, dev)
    return place(img1), place(img2), place(flow)


def rgb_call(lib, dev, img1, img2, flow, out):
    """A call of ``lib``'s rgb warp-norm entry point of ``img1``'s dtype."""
    b, _, h, w = img1.shape
    name = "pivk_rgb_warp_norm_f32" if img1.dtype == torch.float32 else "pivk_rgb_warp_norm_bf16"
    return lambda: call_entry(lib, name, dev, img1.data_ptr(), img2.data_ptr(), flow.data_ptr(), out.data_ptr(),
                              b, h, w)


def check_rgb_kernels(dev, rgb, parent=None):
    """Both forms of ``rgb_warp_norm`` on ``RGB_CASES`` through the op: the float32 form within
    ``WARP_ATOL`` of the plain version, the bf16 form within one bf16 ulp of the float32 plain version
    on its inputs, rounded, plus ``WARP_ATOL`` (``hold``'s test); for both a second launch bit-equal to
    the first and, given ``parent`` (another tree's kernels, ``warp_library``), the parent's output
    bit-equal to this tree's. Each form's two paths, one and two pixels a lane
    (``ops/rgb_warp.py:pixels_a_lane``), must run."""
    bf = torch.bfloat16
    errs = {"rgb_warp_norm": 0.0, "rgb_warp_norm_bf16": 0.0}
    failures = []
    for dtype, name in ((torch.float32, "rgb_warp_norm"), (bf, "rgb_warp_norm_bf16")):
        lanes = {1: 0, 2: 0}
        for i, (b, h, w, kind, off) in enumerate(RGB_CASES):
            img1, img2, flow = rgb_inputs(b, h, w, kind, off, dtype, 900 + i, dev)
            got = rgb.rgb_warp_norm(img1, img2, flow)
            torch.cuda.synchronize()
            j = rgb.pixels_a_lane(b, h, w)
            lanes[j] += 1
            what = f"[{b},3,{h},{w}] {flow_name(kind)}" + (f", {off} elements off" if off else "") + f", {j} a lane"
            ref = rgb.rgb_warp_norm_plain(img1.float(), img2.float(), flow.float())
            if dtype == torch.float32:
                err, tol = (got - ref).abs(), WARP_ATOL
                ok = float(err.max()) <= tol
            else:
                want = ref.to(bf).float()
                err, tol = (got.float() - want).abs(), WARP_ATOL
                ok = got.dtype == bf and int((err > bf16_ulp(want) + tol).sum()) == 0
            same = {"second launch": torch.empty_like(got)}
            rgb._launch(img1, img2, flow, same["second launch"])
            if parent is not None:
                same["parent"] = torch.empty_like(got)
                rgb_call(parent, dev, img1, img2, flow, same["parent"])()
            torch.cuda.synchronize()
            differ = [k for k, o in same.items() if not torch.equal(o.view(torch.uint8), got.view(torch.uint8))]
            ok = ok and not differ
            errs[name] = max(errs[name], float(err.max()))
            log(f"  {name:18s} {what:58s} max_abs_err {float(err.max()):.3e} (tol {tol:.1e}"
                f"{' + 1 bf16 ulp' if dtype == bf else ''}); bit-equal to {', '.join(same)}: "
                f"{'no: ' + ', '.join(differ) if differ else 'yes'}  {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{name} {what}")
            del img1, img2, flow, got, ref, same
        log(f"  {name}: cases by pixels a lane {lanes} (ops/rgb_warp.py:pixels_a_lane)")
        if not all(lanes.values()):
            failures.append(f"{name}: a path of the kernel never ran: {lanes}")
    if failures:
        raise AssertionError(f"rgb warp-norm kernels disagree: {failures}")
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


# The weights the JAX package trained on synthetic PIV (BASELINE.md:603, 664-665), tracked in the
# repository, and their evalset; per version: the weights, JAX's AEE on the evalset through
# evaluate.py in float32 and bf16 (BASELINE.md:629-631, 668) and how far the port's may lie from each
TRAINED = {1: ("work/synth_run/params_final.npz", 0.21952, 0.002, 0.21874, 0.005),
           2: ("work/synth_run_v2/params_final.npz", 0.228, 0.0025, None, None)}
EVALSET = "work/synth_run/evalset"
TRAINED_ATOL = 1e-3  # px: kernels vs plain ops, card vs CPU, float32 chain vs float32 cuDNN


def read_evalset(root: Path):
    """The evalset as evaluate.py reads it (``piv_liteflownet_tpu/data/datasets.py:37-42, 127-148``:
    each ``<base>_img1.png``, ``<base>_img2.png`` as RGB float32 / 255, ``<base>_flow.flo``):
    names, img1 and img2 ``[N,H,W,3]``, ground truth ``[N,H,W,2]``."""
    from piv_liteflownet_tpu_torch.run import load_image
    from piv_liteflownet_tpu_torch.utils.flow_io import read_flow

    names = [f.name[:-len("_img1.png")] for f in sorted(root.glob("*_img1.png"))]
    if not names:
        raise FileNotFoundError(f"no evalset pairs under {root}")
    im1 = np.stack([load_image(str(root / f"{n}_img1.png")) for n in names])
    im2 = np.stack([load_image(str(root / f"{n}_img2.png")) for n in names])
    gt = np.stack([read_flow(str(root / f"{n}_flow.flo")) for n in names])
    return names, im1, im2, gt


def pair_epes(flow: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Each pair's mean end-point error, as evaluate.py:94-99 takes it."""
    return np.array([float(np.linalg.norm(f - g, axis=-1).mean()) for f, g in zip(flow.astype(np.float32), gt)])


def run_trained(dev, ops, card) -> dict:
    """piv v1 and v2 with the tracked trained weights (``run.load_weights``, through
    ``from_jax_params``) on the four evalset pairs (256^2, flows up to 2.5 px), through each path:
    float32 with cuDNN convs and the kernels, float32 through the plain ops on the card, float32
    with the conv chain, bf16 with cuDNN convs and with the chain, and the first pair on the CPU.
    Prints per path the AEE and the worst pair's EPE against the ``.flo`` beside JAX's, the max
    |flow difference| against the float32 kernel path, and per level the largest |flow * sf| that
    reached ``rgb_warp_norm``'s kernel (a hook on ``_launch`` for this phase only). Raises if the
    kernels differ from the plain ops, the card from the CPU, or the float32 chain from cuDNN by more
    than ``TRAINED_ATOL``, or an AEE lies beyond its limit around JAX's (``TRAINED``). Returns the
    AEE of each path on the card, keyed ``(version, "float32 cudnn")`` and so on."""
    from types import SimpleNamespace

    from piv_liteflownet_tpu_torch import piv_liteflownet
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.models.factory import config
    from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS
    from piv_liteflownet_tpu_torch.run import load_weights

    rgb = ops[2]
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    names, im1, im2, gt = read_evalset(root / EVALSET)
    t1, t2 = torch.from_numpy(im1).to(dev), torch.from_numpy(im2).to(dev)
    launch, reach = rgb._launch, {}

    def hooked(img1, img2, flow, out):
        h = flow.shape[2]
        reach[h] = max(reach.get(h, 0.0), float(flow.float().nan_to_num(0.0).abs().max()))
        launch(img1, img2, flow, out)

    failures, aees = [], {}
    for version, (path, jax_f32, tol_f32, jax_bf16, tol_bf16) in TRAINED.items():
        state, _ = load_weights(SimpleNamespace(params=str(root / path), model="piv"), config("piv", version))
        flows, reaches = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            for impl in ("cudnn", "chain"):
                model = piv_liteflownet(state, version=version, device=dev, conv_impl=impl).to(dtype)
                key = f"{'float32' if dtype == torch.float32 else 'bf16'} {impl}"
                reach.clear()
                rgb._launch = hooked
                try:
                    flows[key] = estimate(model, t1, t2, tensor=True).float()
                finally:
                    rgb._launch = launch
                reaches[key] = dict(reach)
                if key == "float32 cudnn":
                    flows["float32 plain ops"] = estimate(model, t1, t2, tensor=True, ops=PLAIN_OPS)
                del model
        cpu_model = piv_liteflownet(state, version=version, device="cpu")
        flows["float32 CPU (first pair)"] = estimate(cpu_model, im1[:1], im2[:1], tensor=True)
        ref = flows["float32 cudnn"]
        diffs = {"kernels vs plain ops": float((ref - flows["float32 plain ops"]).abs().max()),
                 "card vs CPU": float((ref[:1].cpu() - flows["float32 CPU (first pair)"]).abs().max()),
                 "float32 chain vs cuDNN": float((flows["float32 chain"] - ref).abs().max())}
        log(f"  trained piv v{version} ({path}) on {len(names)} evalset pairs {names}: "
            + ", ".join(f"{k} {v:.3e} px" for k, v in diffs.items()) + f" (limit {TRAINED_ATOL:g})")
        failures += [f"v{version} {k}: {v:.3e} px" for k, v in diffs.items() if not v <= TRAINED_ATOL]
        for key, flow in flows.items():
            epes = pair_epes(flow.cpu().numpy(), gt[:len(flow)])
            aee = float(epes.mean())
            aees[version, key] = aee
            jax, tol = ((jax_f32, tol_f32) if key.startswith("float32") and "CPU" not in key
                        else (jax_bf16, tol_bf16) if key.startswith("bf16") else (None, None))
            vs = f", JAX {jax:.5f} (|diff| {abs(aee - jax):.5f}, limit {tol:g})" if jax is not None else ""
            log(f"    {key:26s} AEE {aee:.5f} px, worst pair {epes.max():.5f} ({names[int(epes.argmax())]}), "
                f"max |flow - float32 cudnn| {float((flow.cpu() - ref[:len(flow)].cpu()).abs().max()):.3e}{vs}")
            if jax is not None and not abs(aee - jax) <= tol:
                failures.append(f"v{version} {key}: AEE {aee:.5f} against JAX {jax:.5f}")
        for key in ("float32 cudnn", "bf16 cudnn"):
            levels = sorted(reaches[key].items(), reverse=True)
            log(f"    largest |flow * sf| into rgb_warp_norm's kernel, {key}: "
                + ", ".join(f"{h}x{h}: {v:.3f} px" for h, v in levels))
        del flows, state, cpu_model
    log(f"  trained weights: {time.perf_counter() - t0:.1f} s  ({card})")
    if failures:
        raise AssertionError(f"trained weights: {failures}")
    return aees


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
    del img, flow, grid, flow_r, grid_r, flow2, out
    rows.update(time_rgb(dev, rgb, timer, card, build_log, parent))
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
    corr, warp, _, _ = ops
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
    return rows


def time_rgb(dev, rgb, timer, card, build_log, parent=None):
    """Both forms of ``rgb_warp_norm`` alone (``_launch`` into a preallocated output) at the level-1
    shapes of a 1024^2 pair and of a 256^2 batch-8 training step, each with ``smooth_flow`` and a
    random 8 px flow, in turns with the parent's form (given ``parent``: another tree's kernels,
    ``warp_library``) twice over (tree, parent, parent, tree); beside each its bound from the bytes
    (each input read once, the norm written once), its share of it, and for the float32 form
    ``F.grid_sample`` of the warp half alone on the same inputs (reads img2 and a grid, writes the
    warped rgb; not img1, no norm). The row of each form (the 1024^2 smooth case) also has the op's
    time, the plain version's and ``ptxas``'s lines."""
    rows = {}
    for dtype, name in ((torch.float32, "rgb_warp_norm"), (torch.bfloat16, "rgb_warp_norm_bf16")):
        elt = 4 if dtype == torch.float32 else 2
        cases = []
        for b, h, w in ((1, MAIN_H, MAIN_W), (TRAIN_B, TRAIN_H, TRAIN_W)):
            for kind in ("smooth", 8.0):
                img1, img2, flow = rgb_inputs(b, h, w, kind, 0, dtype, 6, dev)
                out = torch.empty((b, 1, h, w), device=dev, dtype=dtype)
                fns = {"tree": lambda: rgb._launch(img1, img2, flow, out)}
                if parent is not None:
                    fns["parent"] = rgb_call(parent, dev, img1, img2, flow, out)
                turns = in_turns(timer, fns)
                for k, v in in_turns(timer, fns).items():
                    turns[k] += v
                case = dict(shape=f"[{b},3,{h},{w}]", flow=flow_name(kind), launch_ms=float(np.median(turns["tree"])),
                            turns_ms=turns["tree"], parent_turns_ms=turns.get("parent"),
                            bound=bound_ms(elt * 9 * b * h * w, 27 * b * h * w)[0])
                extra = ""
                if dtype == torch.float32:
                    grid = pixel_grid(flow, h, w)
                    case["library_ms"] = timer(lambda: F.grid_sample(img2, grid, mode="bilinear",
                                                                     padding_mode="zeros", align_corners=True))
                    extra = f", F.grid_sample warp half {case['library_ms']:.4f}"
                    del grid
                parent_txt = ("; the parent's " + " / ".join(f"{t:.4f}" for t in turns["parent"])
                              if parent is not None else "")
                log(f"  {name} {case['shape']} {case['flow']}: alone " + " / ".join(f"{t:.4f}" for t in turns["tree"])
                    + f" ms{parent_txt}; bound {case['bound']:.4f} ms (bytes), {case['bound'] / case['launch_ms']:.1%} "
                    f"of it{extra}  ({card})")
                if not cases:
                    rows[name] = dict(
                        shape=case["shape"], ms=timer(lambda: rgb.rgb_warp_norm(img1, img2, flow)),
                        launch_ms=case["launch_ms"], turns_ms=case["turns_ms"],
                        parent_launch_ms=(float(np.median(turns["parent"])) if parent is not None else None),
                        plain_ms=timer(lambda: rgb.rgb_warp_norm_plain(img1, img2, flow)),
                        library_ms=case.get("library_ms"),
                        bound=bound_ms(elt * 9 * b * h * w, 27 * b * h * w),
                        ptxas=ptxas_lines(build_log, "rgb_warp_norm.cu"))
                cases.append(case)
                del img1, img2, flow, out
        rows[name]["cases"] = cases
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


# -- phase 6: the data path and the trainer CLI -------------------------------------------------

DATA_N, DATA_SIZE = 32, (384, 384)  # make_dataset_dir: 24 train and 8 val pairs, frames above the crop
TIME_N = 256  # the timed runs' directory: 192 train pairs, 24 steps an epoch, beyond what the prefetch covers
GEN_ATOL = 1e-5  # px intensity: the render's float32 product over ~45 particles a pixel in another order
AUG_ATOL = 1e-5  # the augmentation's float32 sampling, photometric maps and sums in another order
RESUME_RTOL = 1e-3  # see run_data_path
CLI_PATH = "trainer CLI piv v1 256^2 b8"
CLI_PATH_BF16 = "trainer CLI piv v1 bf16 256^2 b8"
TF32_FLAGS = {"torch's defaults": (False, True), "all TF32 on": (True, True)}  # (matmul, cudnn)


def set_tf32(matmul: bool, cudnn: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def logged_losses(tr, key: str) -> list:
    """(epoch, loss) of every batch of ``key`` ("train_batch", "val_batch") a CLI run logged."""
    rows = [json.loads(line) for line in (Path(tr.experiment.dir) / "metrics.jsonl").read_text().splitlines()]
    return [(r["epoch"], r["value"]) for r in rows if r.get("metric", "").startswith(key)]


def run_cli(ops, root: Path, save: Path, *extra):
    """``trainer.main`` of piv v1 at b8, crop 256^2, on ``root``, with the counts set to 0 just
    before and read just after; its printing goes to ``save/stdout.txt``. Returns the finished
    ``Train``, the counts and the seconds."""
    import contextlib

    from piv_liteflownet_tpu_torch import trainer

    argv = ["--model", "LiteFlowNet", "--batch_size", str(TRAIN_B), "--crop_size", str(TRAIN_H), str(TRAIN_W),
            "--training_dataset_root", str(root), "--validation_dataset_root", str(root),
            "--save", str(save), "--logger_workdir", str(save / "exp"), *extra]
    save.mkdir(parents=True)
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    with open(save / "stdout.txt", "w") as out, contextlib.redirect_stdout(out):
        tr = trainer.main(argv)
    torch.cuda.synchronize()
    return tr, read_counts(ops), time.perf_counter() - t0


def cli_times(tr, steps: int, card: str) -> str:
    """The step times, host waits and idle gaps a CLI run of ``steps`` steps an epoch logged:
    medians and maxima without each epoch's first batch, that batch's on its own."""
    rows = [json.loads(line) for line in (Path(tr.experiment.dir) / "metrics.jsonl").read_text().splitlines()]

    def split(name):
        vals = [(r["step"], r["value"]) for r in rows if r.get("metric") == "train_" + name]
        return ([v for st, v in vals if (st - 1) % steps], [v for st, v in vals if (st - 1) % steps == 0])

    (step, step_first), (wait, wait_first), (idle, _) = split("step_ms"), split("wait_ms"), split("idle_ms")
    if not (len(step) == len(wait) == len(idle) > 0 and len(step_first) == len(wait_first)):
        raise AssertionError(f"trainer CLI times: {len(step)} steps, {len(wait)} waits, {len(idle)} idle gaps")

    def stat(v):
        return f"median {np.median(v):.3f}, max {np.max(v):.3f}"

    return (f"{stat(step)} ms/step over {len(step)} steps (each epoch's first {[round(v, 3) for v in step_first]}); "
            f"host wait for a batch {stat(wait)} ms (each epoch's first {[round(v, 3) for v in wait_first]}); "
            f"the card idle between steps {stat(idle)} ms, {100 * sum(idle) / (sum(idle) + sum(step)):.2f} % of "
            f"those steps' span  ({card})")


def cli_counts(train_steps: int, val_batches: int, bf16: bool) -> dict:
    """The launches of ``train_steps`` piv v1 train steps and ``val_batches`` float32 eval
    forwards: 6/11/6 forward and 6/11 backward a step, 6/11/6 an eval forward."""
    suffix = "_bf16" if bf16 else ""
    counts = dict.fromkeys(("corr49", "backwarp", "rgb_warp_norm", "conv_chain", "corr49_bwd", "backwarp_bwd")
                           + BF16_KERNELS + BF16_BWD_KERNELS, 0)
    for name, n in (("corr49", 6), ("backwarp", 11), ("rgb_warp_norm", 6)):
        counts[name + suffix] += n * train_steps
        counts[name] += n * val_batches
    counts["corr49_bwd" + suffix] += 6 * train_steps
    counts["backwarp_bwd" + suffix] += 11 * train_steps
    return counts


def aug_step_ms(dev, batches: list, pipe, bf16: bool, steps: int = 10) -> float:
    """The piv v1 train step with ``pipe`` inside it on ``batches`` already on the card, in turn,
    timed as ``Train`` times the CLI's steps (CUDA events around each, no synchronisation
    between): the median ms of ``steps`` steps after 3."""
    from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_train_step
    from piv_liteflownet_tpu_torch.training.loss import piv_loss
    from piv_liteflownet_tpu_torch.training.optim import make_optimizer

    model = build_model("piv", 1, "cudnn")
    opt = make_optimizer(model, model.cfg.lowest_level)
    step = make_train_step(model.cfg, piv_loss(), opt, pipeline=pipe,
                           compute_dtype=torch.bfloat16 if bf16 else None)
    state, events = TrainState(model, opt), []
    for i in range(3 + steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, *batches[i % len(batches)], i)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events[3:]]))


def run_data_path(dev, ops, card, f32_step: dict, bf16_step: dict, tmp: Path) -> dict:
    """Phase 6. ``make_dataset_dir`` renders 32 seeded 384^2 pairs on the card into ``tmp``; the card's render and advection are held to the port's CPU render of the same
    particles (each flow field), and the default train pipeline on a b8 batch of that
    directory to the CPU's, with the same drawn factors, under torch's default TF32 flags and
    with every TF32 flag on. Then ``trainer.main`` (piv v1, b8, crop 256^2, the default
    augmentation in the step): 2 epochs with the counts read around it (``CLI_PATH``: the
    train path's kernels and the float32 eval forward, never ``conv_chain``), finite losses,
    checkpoints and ``args.txt``; an unbroken 3-epoch run with backups; ``--resume`` from its
    ``backup_2`` for epoch 3. Resume: the first epoch-3 loss must equal the unbroken run's bit
    for bit (same weights, batch order and draws; the forward is deterministic), the other
    epoch-3 losses within ``RESUME_RTOL``, because the float32 backward is not
    bit-deterministic on the card (``backwarp_bwd``'s float atomics, cuDNN's wgrad) and Adam
    turns ulp-level gradient differences at near-zero gradients into lr-sized steps; the
    2-epoch run against the unbroken one likewise. Then the timed runs, on ``TIME_N`` pairs
    rendered on the card (24 steps an epoch): 2 epochs in float32 and 2 with ``--bf16``, both
    without validation (it would run the float32 eval forward, as JAX's trainer does); under
    ``--bf16`` only the ``_bf16`` forms launch. Prints each timed run's ms/step (CUDA events
    around each step), the host's wait for each batch and the card's idle time between steps
    (``cli_times``: without each epoch's first batch, that batch on its own) beside phase 5's
    fixed-batch steps, the augmentation alone per b8 batch and the same step with the
    augmentation on the run's batches already on the card, and on one of them
    (``aug_step_ms``): what the loader's threads cost the step. Returns the launches of the
    2-epoch run and, for phase 7, the timed runs' directory, steps an epoch, launches, losses
    and times."""
    from piv_liteflownet_tpu_torch.data import transforms
    from piv_liteflownet_tpu_torch.data.datasets import PIVData, get_transform
    from piv_liteflownet_tpu_torch.data.loader import BatchLoader, _collate
    from piv_liteflownet_tpu_torch.data.piv_gen import FLOW_FIELDS, ParticleImageGen, make_dataset_dir

    h, w = DATA_SIZE
    root = tmp / "data"
    set_tf32(*TF32_FLAGS["torch's defaults"])
    try:
        t0 = time.perf_counter()
        make_dataset_dir(str(root), n=DATA_N, size=DATA_SIZE, seed=0, device=dev)
        gen_s = time.perf_counter() - t0
        gen = ParticleImageGen(image_size=DATA_SIZE)
        gen_err = dict.fromkeys(TF32_FLAGS, 0.0)
        for i, (name, field) in enumerate(FLOW_FIELDS.items()):
            flow = field(h, w, device="cpu")
            parts = gen.sample_particles(torch.Generator().manual_seed(i), "cpu")
            want = gen.advect(parts, flow)
            for flags, (mm, cd) in TF32_FLAGS.items():
                set_tf32(mm, cd)
                got = gen.advect(tuple(p.to(dev) for p in parts), flow)
                gen_err[flags] = max(gen_err[flags], *(float((g.cpu() - r).abs().max()) for g, r in zip(got, want)))
        set_tf32(*TF32_FLAGS["torch's defaults"])
        if not max(gen_err.values()) <= GEN_ATOL:
            raise AssertionError(f"generator card vs CPU {gen_err}, tolerance {GEN_ATOL}")
        train_ds = PIVData(str(root), "train")
        val_n = len(PIVData(str(root), "val"))
        n_train = int(0.75 * DATA_N)
        if (len(train_ds), val_n, train_ds.render_size) != (n_train, DATA_N - n_train, (h // 64 * 64, w // 64 * 64)):
            raise AssertionError(f"dataset: {len(train_ds)} train, {val_n} val, {train_ds.render_size}")
        steps, val_batches = n_train // TRAIN_B, -(-val_n // TRAIN_B)  # an epoch's
        log(f"  make_dataset_dir on the card: {DATA_N} pairs {h}x{w} in {gen_s:.2f} s; render + advection "
            f"card vs CPU on the same particles, max abs diff {gen_err} (tolerance {GEN_ATOL})")

        (im1, im2), flow = _collate([train_ds[i] for i in range(TRAIN_B)])
        batch_cpu = [torch.from_numpy(a) for a in (im1, im2, flow)]
        batch = [a.to(dev) for a in batch_cpu]
        pipe = get_transform(crop_size=(TRAIN_H, TRAIN_W), mode="train")
        params = transforms.draw_params(pipe, TRAIN_B, h, w, torch.Generator(device=dev).manual_seed(0))
        want = transforms.augment({k: v.cpu() for k, v in params.items()}, *batch_cpu, pipe)
        aug_err = {}
        for flags, (mm, cd) in TF32_FLAGS.items():
            set_tf32(mm, cd)
            got = transforms.augment(params, *batch, pipe)
            aug_err[flags] = [float((g.cpu() - r).abs().max()) for g, r in zip(got, want)]
        set_tf32(*TF32_FLAGS["torch's defaults"])
        if not max(max(e) for e in aug_err.values()) <= AUG_ATOL:
            raise AssertionError(f"augmentation card vs CPU (img1, img2, flow) {aug_err}, tolerance {AUG_ATOL}")
        aug_ms = Timer(dev)(lambda: transforms.apply_pipeline(5, *batch, pipe), iters=20)
        fixed_aug = {False: aug_step_ms(dev, [batch], pipe, False), True: aug_step_ms(dev, [batch], pipe, True)}
        log(f"  default train pipeline b{TRAIN_B} {h}x{w} -> {TRAIN_H}x{TRAIN_W}, card vs CPU with the same "
            f"draws, max abs diff (img1, img2, flow) {aug_err} (tolerance {AUG_ATOL}); draw + apply alone "
            f"{aug_ms:.4f} ms per batch (L2 flushed before each)")
    finally:
        set_tf32(False, False)

    cli = tmp / "cli"
    two, counts, secs = run_cli(ops, root, cli / "two", "--total_epochs", "2")
    want_counts = cli_counts(2 * steps, 2 * val_batches, bf16=False)
    if counts != want_counts:
        raise AssertionError(f"trainer CLI launches {counts}, expected {want_counts}")
    names = sorted(p.name for p in (cli / "two").iterdir())
    for want_name in ("LiteFlowNet_checkpoint", "LiteFlowNet_model_best", "backup_1", "args.txt"):
        if want_name not in names:
            raise AssertionError(f"trainer CLI wrote no {want_name}: {names}")
    two_train, two_val = logged_losses(two, "train_batch"), logged_losses(two, "val_batch")
    if (len(two_train), len(two_val)) != (2 * steps, 2 * val_batches) or \
            not all(np.isfinite([v for _, v in two_train + two_val])):
        raise AssertionError(f"trainer CLI losses {two_train} {two_val}")
    log(f"  trainer CLI piv v1 b{TRAIN_B} {TRAIN_H}^2, 2 epochs of {steps} steps + validation in {secs:.2f} s: "
        f"launches {counts}; train losses {[round(v, 6) for _, v in two_train]}, val {[round(v, 6) for _, v in two_val]}")

    unbroken, _, _ = run_cli(ops, root, cli / "unbroken", "--total_epochs", "3", "--backup_frequency", "1")
    resumed, _, _ = run_cli(ops, root, cli / "resumed", "--total_epochs", "3",
                            "--resume", str(cli / "unbroken" / "backup_2"))
    u_train, u_val = logged_losses(unbroken, "train_batch"), logged_losses(unbroken, "val_batch")
    r_train, r_val = logged_losses(resumed, "train_batch"), logged_losses(resumed, "val_batch")
    if resumed.args.start_epoch != 3 or {e for e, _ in r_train + r_val} != {3}:
        raise AssertionError(f"the resumed run started at epoch {resumed.args.start_epoch}: {r_train}")

    def rel(a, b):
        return max(abs(x - y) / abs(y) for (_, x), (_, y) in zip(a, b))

    e3, v3 = 2 * steps, 2 * val_batches  # where epoch 3 starts in the unbroken run's losses
    resume_rel = rel(r_train + r_val, u_train[e3:] + u_val[v3:])
    rerun_rel = rel(two_train + two_val, u_train[:e3] + u_val[:v3])
    if len(r_train) != steps or r_train[0] != u_train[e3] or two_train[0] != u_train[0]:
        raise AssertionError(f"a first loss differs: resumed {r_train} vs {u_train[e3:]}, "
                             f"rerun {two_train[0]} vs {u_train[0]}")
    if not max(resume_rel, rerun_rel) <= RESUME_RTOL:
        raise AssertionError(f"resume: epoch 3 {r_train} {r_val} vs unbroken {u_train[e3:]} {u_val[v3:]}; "
                             f"epochs 1-2 {two_train} vs {u_train[:e3]}")
    log(f"  --resume from backup_2 starts at epoch 3: its first loss {r_train[0][1]!r} equals the unbroken run's "
        f"bit for bit; epoch 3 within rel {resume_rel:.3e} (train and val; tolerance {RESUME_RTOL}); the 2-epoch "
        f"run against the unbroken run's epochs 1-2 within rel {rerun_rel:.3e}, first loss equal")

    timed_root = tmp / "timed"
    t0 = time.perf_counter()
    make_dataset_dir(str(timed_root), n=TIME_N, size=DATA_SIZE, seed=1)  # on the card
    gen_s = time.perf_counter() - t0
    t_steps = len(PIVData(str(timed_root), "train")) // TRAIN_B
    log(f"  make_dataset_dir on the card: {TIME_N} pairs {h}x{w} in {gen_s:.2f} s, {t_steps} steps an epoch")
    resident = [tuple(torch.from_numpy(a).to(dev) for a in (im1, im2, flow)) for (im1, im2), flow in
                BatchLoader(PIVData(str(timed_root), "train"), TRAIN_B, num_workers=8, drop_last=True)]
    own_aug = {bf: aug_step_ms(dev, resident, pipe, bf, steps=2 * (t_steps - 1)) for bf in (False, True)}
    del resident
    timed = {}
    for tag, flags in (("float32", ()), ("bf16", ("--bf16",))):
        tr, got, secs = run_cli(ops, timed_root, cli / tag, *flags, "--total_epochs", "2",
                                "--validation_dataset_mode", "none")
        want = cli_counts(2 * t_steps, 0, bf16=bool(flags))
        losses = logged_losses(tr, "train_batch")
        if got != want or len(losses) != 2 * t_steps or not all(np.isfinite([v for _, v in losses])):
            raise AssertionError(f"trainer CLI {tag} launches {got} (expected {want}), losses {losses}")
        log(f"  trainer CLI {tag}, 2 epochs of {t_steps} steps without validation in {secs:.2f} s: launches {got}; "
            f"first and last train losses {losses[0][1]:.6f} {losses[-1][1]:.6f}")
        timed[tag] = {"launches": got, "losses": losses, "times": cli_times(tr, t_steps, card)}
        fixed = bf16_step if flags else f32_step
        log(f"  trainer CLI {tag}, 2 epochs of {t_steps} steps (CUDA events around each step, augmentation "
            f"included): {timed[tag]['times']}")
        log(f"    beside: the same step with the augmentation on the run's {t_steps} batches already on the card, "
            f"no loader {own_aug[bool(flags)]:.3f} ms (events, median of {2 * (t_steps - 1)}), on one batch "
            f"{fixed_aug[bool(flags)]:.3f} ms (events, median of 10); phase 5's fixed batch without "
            f"augmentation {fixed['ms_step']:.3f} ms/step (host clock, synchronised)")
    log(f"  augmentation alone {aug_ms:.4f} ms per b{TRAIN_B} batch ({card})")
    return {"launches": counts, "launches_bf16": timed["bf16"]["launches"], "timed": timed,
            "timed_root": timed_root, "t_steps": t_steps}


# -- phase 7: ingest and the inference CLIs ------------------------------------------------------

INGEST_N, INGEST_SIZE = 64, (1024, 1024)  # run's directory: 64 pairs rendered on the card
RUN_B = 2  # run's default --batch_size
EVAL_ATOL = 1e-5  # px: evaluate's AEE against run_trained's for the same path (the same batch of 4)
#: (version, dtype, conv_impl) of evaluate's runs, their run_trained key, launches per estimate at 256^2
EVAL_CASES = [(1, "float32", "cudnn", (6, 11, 6, 0)), (1, "float32", "chain", (6, 11, 6, 12)),
              (1, "bf16", "cudnn", (6, 11, 6, 0)), (1, "bf16", "chain", (6, 11, 6, 12)),
              (2, "float32", "cudnn", (5, 9, 5, 0))]
#: run's flags, launches per estimate and runs of each route (the median is reported): float32 is
#: card-bound and its 9 runs in one call spread 1.3 %, so 2 runs a route; bf16 spreads up to 40 %
RUN_DTYPES = {"float32 cudnn": ((), (6, 11, 6, 0), 2),
              "bf16 chain": (("--bf16", "--conv_impl", "chain"), (6, 11, 6, 18), 3)}


def forward_counts(per_estimate, calls: int, bf16: bool) -> dict:
    """The launches of ``calls`` estimates, each launching ``per_estimate`` of corr49, backwarp,
    rgb_warp_norm and conv_chain, in the bf16 forms when ``bf16``."""
    counts = dict.fromkeys(("corr49", "backwarp", "rgb_warp_norm", "conv_chain", "corr49_bwd", "backwarp_bwd")
                           + BF16_KERNELS + BF16_BWD_KERNELS, 0)
    for name, n in zip(FWD_KERNELS, per_estimate):
        counts[name + ("_bf16" if bf16 else "")] = n * calls
    return counts


def quiet(fn, *args):
    """``fn(*args)`` with its printing captured; returns (result, what it printed)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


class EstimateEvents:
    """Within ``with``: ``module.estimate`` records a CUDA event on the current stream before
    and after each call, into ``events`` as (start, end); the module's own function comes
    back on exit. The main path holds no timing of its own."""

    def __init__(self, module):
        self.module = module
        self.events: list = []

    def __enter__(self):
        inner = self.own = self.module.estimate

        def estimate(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        self.module.estimate = estimate
        return self

    def __exit__(self, *exc):
        self.module.estimate = self.own


def idle_share(events) -> tuple:
    """The card's time between one ``estimate``'s end and the next one's start over a run (the
    gaps between each (start, end) pair of CUDA events and the next; a batch's flows are
    copied back in the gap after it), as (ms, share of the span)."""
    torch.cuda.synchronize()
    gaps = sum(max(0.0, e.elapsed_time(s)) for (_, e), (s, _) in zip(events, events[1:]))
    span = events[0][0].elapsed_time(events[-1][1])
    return gaps, gaps / span if span > 0 else 0.0


def check_decode(native, pivseq, tmp: Path) -> None:
    """The evalset's PNGs through ``image_read`` bit-equal to PIL's values over 255; its ``.flo``
    files through the native codec bit-equal to ``utils/flow_io.py``; a ``.pivseq`` packed from
    it read back bit-equal, by Python and by C."""
    from piv_liteflownet_tpu_torch.run import load_image
    from piv_liteflownet_tpu_torch.utils.flow_io import read_flow, write_flow

    root = Path(__file__).resolve().parent / EVALSET
    pngs, flos = sorted(root.glob("*_img[12].png")), sorted(root.glob("*_flow.flo"))
    if native.has_png():
        for p in pngs:
            if not np.array_equal(native.image_read(str(p)), load_image(str(p))):
                raise AssertionError(f"image_read({p.name}) differs from PIL's")
    for f in flos:
        flow = read_flow(str(f))
        if not np.array_equal(native.flo_read(str(f)), flow):
            raise AssertionError(f"flo_read({f.name}) differs from read_flow")
        a, b = tmp / "native.flo", tmp / "python.flo"
        native.flo_write(str(a), flow)
        write_flow(flow, str(b))
        if a.read_bytes() != b.read_bytes():
            raise AssertionError(f"flo_write({f.name}) differs from write_flow's bytes")
    seq = pivseq.pack_directory(str(root), str(tmp / "evalset.pivseq"))
    reader = pivseq.PivseqReader(seq)
    for i, name in enumerate(reader.names):
        want = load_image(str(root / name))
        if not (np.array_equal(reader.frame(i), want)
                and np.array_equal(native.seq_read_frame(seq, i, reader.h, reader.w), want)):
            raise AssertionError(f".pivseq frame {name} differs from PIL's")
    log(f"  decode: {len(pngs)} evalset PNGs through image_read {'bit-equal to PIL' if native.has_png() else 'not checked (no PNG decoder)'}; "
        f"{len(flos)} .flo through the native codec bit-equal to flow_io (read and write); the evalset packed "
        f"({reader.n_frames} frames {reader.h}x{reader.w}x{reader.c} {reader.np_dtype.__name__}) read back bit-equal")


def run_evaluate(ops, card, trained_aees: dict) -> dict:
    """``evaluate.main`` in-process with the tracked trained weights on the evalset, per
    ``EVAL_CASES``: its AEE within ``EVAL_ATOL`` of ``run_trained``'s for the same path and
    within ``TRAINED``'s limits of JAX's; its launches exactly one estimate's (4 pairs of one
    shape: one batch). Returns the launches by path."""
    from piv_liteflownet_tpu_torch import evaluate

    root = Path(__file__).resolve().parent
    paths, failures = {}, []
    for version, dtype, impl, per_estimate in EVAL_CASES:
        path, jax_f32, tol_f32, jax_bf16, tol_bf16 = TRAINED[version]
        argv = ["-i", str(root / EVALSET), "-m", "piv", "-v", str(version), "--params", str(root / path),
                "--conv_impl", impl] + (["--bf16"] if dtype == "bf16" else [])
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        agg, printed = quiet(evaluate.main, argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts(ops)
        want = forward_counts(per_estimate, 1, dtype == "bf16")
        key = f"{dtype} {impl}"
        ref = trained_aees[version, key]
        jax, tol = (jax_f32, tol_f32) if dtype == "float32" else (jax_bf16, tol_bf16)
        last = json.loads(printed.strip().splitlines()[-1])
        ok = (counts == want and last == {"aggregate": agg} and agg["pairs"] == 4
              and abs(agg["aee"] - ref) <= EVAL_ATOL and abs(agg["aee"] - jax) <= tol)
        log(f"  evaluate piv v{version} {key}: AEE {agg['aee']:.6f} px (run_trained {ref:.6f}, |diff| "
            f"{abs(agg['aee'] - ref):.2e}, limit {EVAL_ATOL:g}; JAX {jax}, limit {tol}), worst pair "
            f"{agg['worst_pair_epe']:.5f}, {secs:.2f} s in-process (model build included), launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not ok:
            failures.append(f"v{version} {key}: AEE {agg['aee']} vs {ref} (JAX {jax}), launches {counts} "
                            f"(expected {want}), last line {last}")
        paths[f"evaluate piv v{version} {key} evalset 4x256^2"] = counts
    if failures:
        raise AssertionError(f"evaluate: {failures}")
    log(f"  ({card})")
    return paths


def ingest_rate(loader) -> float:
    """Pairs a second through ``loader`` alone, its batches dropped."""
    t0, n = time.perf_counter(), 0
    for _, names in loader:
        n += len(names)
    if hasattr(loader, "close"):
        loader.close()
    return n / (time.perf_counter() - t0)


def same_files(a: Path, b: Path) -> list:
    """The names of ``a``'s files whose bytes differ from ``b``'s, or that ``b`` lacks."""
    import filecmp

    names = sorted(p.name for p in a.iterdir())
    if names != sorted(p.name for p in b.iterdir()):
        return ["file names differ"]
    return [n for n in names if not filecmp.cmp(a / n, b / n, shallow=False)]


def flow_dir(out: Path) -> Path:
    """The ``flow`` directory ``run`` wrote under ``out`` for its one input."""
    (net,) = out.iterdir()
    (sub,) = net.iterdir()
    return sub / "flow"


def run_cli_routes(dev, ops, card, tmp: Path) -> dict:
    """``run``'s directory path over ``INGEST_N`` 1024^2 pairs rendered on the card and written
    as 8-bit PNGs, three ways: PIL threads, ``--native_io`` (libpivio's PNG decoder) and the
    directory packed into a ``.pivseq`` by the pack CLI (with ``--native_io``); piv v1 with the
    trained v1 weights in float32 with cuDNN and in bf16 with the chain. Each route's files
    bit-equal to the others', the launches of each run exact, ``RUN_DTYPES``' runs of each route in
    turns (pairs/s: the median), beside ``estimate`` alone on the run's first batch resident on the
    card (synchronised calls, and 10 calls back to back) and each ingest route alone; the
    card's idle share between batches of each run. Then
    ``-b 1.0 -c 1.0`` (JAX's names; flows bit-equal to the plain path's at batch 1) and
    ``-b 0.8 1.2`` (file count). Returns the launches by path."""
    import shutil
    from types import SimpleNamespace

    from piv_liteflownet_tpu_torch import piv_liteflownet
    from piv_liteflownet_tpu_torch import run as infer_cli
    from piv_liteflownet_tpu_torch.data import pivseq
    from piv_liteflownet_tpu_torch.data.datasets import Run
    from piv_liteflownet_tpu_torch.data.loader import BatchLoader, native_loader_for
    from piv_liteflownet_tpu_torch.data.piv_gen import make_dataset_dir
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.models.factory import config
    from piv_liteflownet_tpu_torch.utils.flow_io import read_flow

    root = Path(__file__).resolve().parent
    weights = str(root / TRAINED[1][0])
    frames = tmp / "frames"
    t0 = time.perf_counter()
    make_dataset_dir(str(frames), n=INGEST_N, size=INGEST_SIZE, seed=7, device=dev, write_manifest=False)
    gen_s = time.perf_counter() - t0
    seq = tmp / "frames.pivseq"
    t0 = time.perf_counter()
    _, printed = quiet(pivseq.main, [str(frames), str(seq)])
    pack_s = time.perf_counter() - t0
    h, w = INGEST_SIZE
    log(f"  {INGEST_N} pairs {h}x{w} rendered on the card and written as 8-bit PNGs in {gen_s:.2f} s; "
        f"pack CLI in {pack_s:.2f} s: {printed.strip()}")

    alone = {"PIL threads": ingest_rate(BatchLoader(Run(str(frames), is_pair=True), RUN_B, num_workers=4)),
             "native PNG": ingest_rate(native_loader_for(Run(str(frames), is_pair=True), RUN_B)),
             ".pivseq": ingest_rate(native_loader_for(pivseq.PivseqRun(str(seq), is_pair=True), RUN_B))}
    log(f"  ingest alone at {h}x{w} b{RUN_B} (pairs/s, host clock, os.cpu_count() {os.cpu_count()}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in alone.items()) + f"  ({card})")

    routes = {"PIL threads": [str(frames)], "native PNG": [str(frames), "--native_io"],
              ".pivseq": [str(seq), "--native_io"]}
    batches = -(-INGEST_N // RUN_B)
    state, _ = infer_cli.load_weights(SimpleNamespace(params=weights, model="piv"), config("piv", 1))
    firsts = sorted(frames.glob("*_img1.png"))[:RUN_B]
    t1 = torch.from_numpy(np.stack([infer_cli.load_image(str(p)) for p in firsts])).to(dev)
    t2 = torch.from_numpy(np.stack([infer_cli.load_image(str(p).replace("_img1", "_img2")) for p in firsts])).to(dev)
    paths, failures = {}, []
    for dtype, (flags, per_estimate, reps) in RUN_DTYPES.items():
        model = piv_liteflownet(state, version=1, device=dev, conv_impl="chain" if "chain" in dtype else "cudnn")
        if "bf16" in dtype:
            model = model.to(torch.bfloat16)
        ms = []
        for _ in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            estimate(model, t1, t2, tensor=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        est = float(np.median(ms[3:]))
        t0 = time.perf_counter()
        for _ in range(10):  # back to back: the host may launch ahead of the card
            estimate(model, t1, t2, tensor=True)
        torch.cuda.synchronize()
        ahead = (time.perf_counter() - t0) * 1e3 / 10
        del model
        rates, idle, ref = {r: [] for r in routes}, {r: [] for r in routes}, None
        for rep in range(reps):
            for route, inp in routes.items():
                out = tmp / "run" / f"{dtype.replace(' ', '_')}_{rep}_{route.replace(' ', '_').strip('.')}"
                argv = ["-m", "piv", "-v", "1", "-p", "--params", weights, "-o", str(out), "-i", *inp, *flags]
                torch.cuda.synchronize()
                reset_counts(ops)
                with EstimateEvents(infer_cli) as timed:
                    (stats,), _ = quiet(infer_cli.main, argv)
                torch.cuda.synchronize()
                counts = read_counts(ops)
                want = forward_counts(per_estimate, batches, "bf16" in dtype)
                loader = "native" if "--native_io" in inp else "python"
                if counts != want or stats.pairs != INGEST_N or stats.loader != loader:
                    failures.append(f"run {dtype} {route}: launches {counts} (expected {want}), {stats.pairs} "
                                    f"pairs, loader {stats.loader}")
                rates[route].append(stats.pairs / stats.seconds)
                idle[route].append(idle_share(timed.events))
                if rep == 0:
                    paths[f"run piv v1 {dtype} {h}^2 b{RUN_B} x{INGEST_N}, {route}"] = counts
                if ref is None:
                    ref = flow_dir(out)
                    flows = [read_flow(str(p)) for p in sorted(ref.iterdir())[:2]]
                    if len(list(ref.iterdir())) != INGEST_N or not all(
                            f.shape == (h, w, 2) and np.isfinite(f).all() for f in flows):
                        failures.append(f"run {dtype}: bad output in {ref}")
                    continue
                if rep == 0:
                    diff = same_files(flow_dir(out), ref)
                    if diff:
                        failures.append(f"run {dtype} {route}: files differ from PIL threads' {diff[:3]}")
                shutil.rmtree(out)
        shutil.rmtree(ref.parents[2])
        log(f"  run piv v1 {dtype} b{RUN_B} over {INGEST_N} {h}x{w} pairs, {reps} runs a route in turns "
            f"(pairs/s, median [all]; the card idle between estimates, the flows' copy back included, ms and "
            f"share of the span): "
            + "; ".join(f"{r} {np.median(v):.2f} {[round(x, 2) for x in v]}, idle "
                        f"{[round(g, 1) for g, _ in idle[r]]} ms {[f'{100 * sh:.1f} %' for _, sh in idle[r]]}"
                        for r, v in rates.items())
            + f"; estimate alone on the run's first batch resident on the card {est:.3f} ms "
              f"({1e3 * RUN_B / est:.2f} pairs/s, median of 10 synchronised calls), {ahead:.3f} ms back to back "
              f"({1e3 * RUN_B / ahead:.2f} pairs/s, 10 calls)  ({card}, os.cpu_count() {os.cpu_count()})")
        log(f"    the three routes wrote the same {INGEST_N} file names, bit-equal .flo files")
    del t1, t2

    mod = tmp / "mod"
    argv = ["-m", "piv", "-v", "1", "--params", weights]
    (one,), _ = quiet(infer_cli.main, argv + ["-o", str(mod / "one"), "-i", str(frames), "-n", "8",
                                                "-b", "1.0", "-c", "1.0"])
    quiet(infer_cli.main, argv + ["-o", str(mod / "plain"), "-i", str(frames), "-p", "-n", "4", "--batch_size", "1"])
    want_names = []
    for a in infer_cli.mod_images(str(frames), 0, 8)[:-1]:
        prefix, suffix = Path(a).name.rsplit("_", 1)
        want_names.append(f"{prefix}_100_100_{suffix.rsplit('.', 1)[0]}_out.flo")
    got_names = [Path(p).name for p in one]
    if got_names != want_names:
        failures.append(f"run -b 1.0 -c 1.0 wrote {got_names}, JAX's pattern gives {want_names}")
    plain_dir = flow_dir(mod / "plain")
    same = 0
    for p in one:
        name = Path(p).name
        if name.endswith("_img1_out.flo"):
            ref = plain_dir / name.replace("_100_100_img1", "_img1")
            if not np.array_equal(read_flow(p), read_flow(str(ref))):
                failures.append(f"run -b 1.0 -c 1.0: {name} differs from the plain path's {ref.name}")
            same += 1
    (two,), _ = quiet(infer_cli.main, argv + ["-o", str(mod / "two"), "-i", str(frames), "-n", "4",
                                                "-b", "0.8", "1.2"])
    two_names = sorted(Path(p).name for p in two)
    if len(two_names) != 2 * 3 or not all(("_080_100_" in n) or ("_120_100_" in n) for n in two_names):
        failures.append(f"run -b 0.8 1.2 -n 4 wrote {two_names}")
    log(f"  run -b 1.0 -c 1.0 -n 8: {len(got_names)} files named as JAX's pattern ({got_names[0]}, ...), the {same} "
        f"img1->img2 pairs bit-equal to the plain path's at batch 1; -b 0.8 1.2 -n 4: {len(two_names)} files")
    if failures:
        raise AssertionError(f"run: {failures}")
    return paths


def native_batches_on_the_card(dev, root: Path) -> int:
    """One shuffled epoch of ``root``'s train split through ``native_train_loader_for`` (its
    pinned ring, fenced by the copies) and through ``BatchLoader``, each to the card by
    ``PrefetchLoader``: every batch equal bit for bit. Returns the batches compared."""
    from piv_liteflownet_tpu_torch.data.datasets import PIVData
    from piv_liteflownet_tpu_torch.data.loader import BatchLoader, PrefetchLoader, native_train_loader_for

    ds = PIVData(str(root), "train")
    native = native_train_loader_for(ds, TRAIN_B, num_workers=8, shuffle=True, seed=1, drop_last=True)
    python = BatchLoader(ds, TRAIN_B, num_workers=8, shuffle=True, seed=1, drop_last=True)
    n = 0
    for ((a1, a2), af), ((b1, b2), bf) in zip(PrefetchLoader(native, dev, fence=native.fence),
                                              PrefetchLoader(python, dev)):
        if not (a1.device.type == torch.device(dev).type and torch.equal(a1, b1) and torch.equal(a2, b2) and torch.equal(af, bf)):
            raise AssertionError(f"trainer --native_io: batch {n} on the card differs from the Python loader's")
        n += 1
    if n != len(python):
        raise AssertionError(f"trainer --native_io: {n} batches compared of {len(python)}")
    return n


def run_native_trainer(dev, ops, card, cli: dict, tmp: Path) -> dict:
    """``trainer.main --native_io`` on phase 6's timed directory (crop 256^2 b8, 2 epochs, no
    validation), float32 and bf16: an epoch of its batches on the card bit-equal to the Python
    loader's; launches as phase 6's Python-loader runs and every loss bit-equal to theirs (the
    same batch order, decoded values, draws and weights; the backward's float atomics have
    given the same sums in every call so far); its step times, host waits and idle gaps beside
    phase 6's."""
    from piv_liteflownet_tpu_torch.data.native import NativeTrainLoader

    n = native_batches_on_the_card(dev, cli["timed_root"])
    log(f"  trainer data: {n} shuffled b{TRAIN_B} batches through libpivio's pinned ring to the card, bit-equal "
        f"to the Python loader's")
    paths, failures = {}, []
    for tag, flags in (("float32", ()), ("bf16", ("--bf16",))):
        tr, got, secs = run_cli(ops, cli["timed_root"], tmp / "native_cli" / tag, "--native_io", *flags,
                                "--total_epochs", "2", "--validation_dataset_mode", "none")
        python = cli["timed"][tag]
        losses = logged_losses(tr, "train_batch")
        same = sum(a == b for a, b in zip(losses, python["losses"]))
        if not isinstance(tr.loaders["train"], NativeTrainLoader) or got != python["launches"] \
                or len(losses) != len(python["losses"]) or same != len(losses):
            failures.append(f"{tag}: loader {type(tr.loaders['train']).__name__}, launches {got} vs "
                            f"{python['launches']}, {same} of {len(losses)} losses bit-equal, {losses[:3]} vs "
                            f"{python['losses'][:3]}")
        log(f"  trainer CLI --native_io {tag}, 2 epochs of {cli['t_steps']} steps in {secs:.2f} s: launches as the "
            f"Python loader's; {same} of {len(losses)} losses bit-equal to the Python loader's (first "
            f"{losses[0][1]!r})")
        log(f"    native: {cli_times(tr, cli['t_steps'], card)}")
        log(f"    Python loader (phase 6, this call): {python['times']}")
        paths[f"trainer CLI --native_io piv v1 {tag} 256^2 b8"] = got
    if failures:
        raise AssertionError(f"trainer --native_io: {failures}")
    return paths


def run_ingest(dev, ops, card, trained_aees: dict, cli: dict, tmp: Path) -> dict:
    """Phase 7: build libpivio, check its decoders and codec, then ``evaluate``, ``run``'s
    three ingest routes and ``trainer --native_io`` (see each). Returns the launches by path."""
    from piv_liteflownet_tpu_torch.data import native, pivseq

    res = native.build()
    native.load()
    log(f"  libpivio: {res.compiler}; {'built' if res.rebuilt else 'up to date'} in {res.seconds:.2f} s -> "
        f"{res.path.name}; zlib's header {'found' if native.zlib_header_found() else 'missing'}, PNG decoder "
        f"{'in' if res.png else 'compiled out (PNG datasets take the Python loader)'}")
    check_decode(native, pivseq, tmp)
    paths = run_evaluate(ops, card, trained_aees)
    paths.update(run_cli_routes(dev, ops, card, tmp))
    paths.update(run_native_trainer(dev, ops, card, cli, tmp))
    return paths



#: The parent tree's sources built beside this tree's, those of them that it has (before its own
#: sources for the bf16 cost volumes, their forms lived in the float32 forms' sources).
# -- phase 8: training extras, post-processing and stereo ---------------------------------------

REMAT_CASES = ((1, None), (1, torch.bfloat16), (2, None), (2, torch.bfloat16))
#: gradients remat vs not, per parameter, both steps with cuDNN's deterministic algorithms (its
#: default backward varies in order): float32 atol 1e-5 * max|g|; bf16 two bf16 ulps of max|g|,
#: because v2's output resize adds its bf16 gradient with atomics (each add rounded to bf16, in a
#: varying order) even so: a second run of the same step differs by one ulp there too
REMAT_RTOL = 1e-5
REMAT_BF16_ULPS = 2
REMAT_TURNS = 10  # timed steps of each, in turns
PATH_REMAT = "remat step piv v1 256^2 b8"
PATH_REMAT_BF16 = "remat step piv v1 256^2 b8 bf16"
PATH_STEREO = "stereo_run direct piv v1 1024^2, 8 stereo pairs"
OWN_OPTIMIZERS = ("Lion", "Lamb", "Yogi", "Novograd")
OPT_ATOL = 1e-6  # params after two optimizer steps, card vs CPU from the same gradients
POSTPRO_ATOL = 1e-6  # vorticity and strains, card vs CPU on the same flows
#: the kernels a float32 remat step must show in a profiler trace, by their device names
TRACE_KERNELS = ("corr49_kernel", "backwarp_kernel", "rgb_warp_norm_lanes_kernel", "corr49_bwd_kernel",
                 "backwarp_bwd_kernel")
STEREO_N, STEREO_SIZE = 8, 1024  # stereo_run's directory: 8 stereo pairs rendered on the card
STEREO_ATOL = 1e-4  # px: direct against manual on the card
STEREO_CPU_ATOL = 1e-3  # px: direct on the card against --cpu, one 256^2 pair
CAL_ATOL = 0.01  # px: the fitted mappings of the grid points, card against CPU
PLATE_SIZE, PLATE_PITCH = 1024, 40


def plate_distortion(shift: float) -> np.ndarray:
    """A camera's mild rational distortion of the calibration plate (``nl_trans`` coefficients,
    about the image centre), shifted by ``shift`` px in x."""
    A = np.zeros(24)
    A[[0, 1, 2, 3, 6, 8]] = [1.0, 0.02, shift, 2e-5, 1e-5, 1.0]
    A[[12, 13, 16, 19, 20]] = [-0.015, 1.0, 1e-5, -1e-5, 1.0]
    return A


def remat_case(dev, ops, card, version: int, dtype) -> dict:
    """``make_train_step(remat=True)`` beside the same step without it, piv ``version`` at 256^2
    b8 on phase 5's batch, from the same weights: launches (every forward kernel twice the
    step's, every backward kernel as often), loss and gradients (``REMAT_RTOL``: the first step
    of each with ``cudnn.deterministic``; a second run of the step without remat shows the card's
    own spread), ms/step (median and p90 of ``REMAT_TURNS``, in turns),
    peak memory of one step and, in float32, the memory the train forward keeps for the
    backward."""
    from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_train_step
    from piv_liteflownet_tpu_torch.training.loss import piv_loss, v2_multiscale
    from piv_liteflownet_tpu_torch.training.optim import make_optimizer
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    shift = (2.5, -1.5)
    im1, im2 = particle_pair(TRAIN_B, TRAIN_H, TRAIN_W, seed=20 if version == 1 else 21, shift=shift)
    target = np.empty((TRAIN_B, TRAIN_H, TRAIN_W, 2), np.float32)
    target[...] = shift
    batch = tuple(torch.from_numpy(a).to(dev) for a in (im1, im2, target))
    loss_obj = piv_loss() if version == 1 else v2_multiscale()
    runs = {}
    for remat in (False, True, "repeat"):
        model = build_model("piv", version, "cudnn")
        opt = make_optimizer(model, model.cfg.lowest_level)
        step = make_train_step(model.cfg, loss_obj, opt, remat=remat is True, compute_dtype=dtype)
        state = TrainState(model, opt)
        torch.cuda.synchronize()
        reset_counts(ops)
        torch.backends.cudnn.deterministic = True
        try:
            state, metrics = step(state, *batch)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        runs[remat] = {"state": state, "step": step, "counts": read_counts(ops), "loss": float(metrics["loss"]),
                       "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()}}
    plain, rem, repeat = runs[False], runs[True], runs.pop("repeat")
    sfx = "_bf16" if dtype is not None else ""
    want = dict(plain["counts"])
    for name in FWD_KERNELS[:3]:
        want[name + sfx] *= 2
    if plain["counts"]["corr49" + sfx] == 0 or rem["counts"] != want:
        raise AssertionError(f"remat step launches {rem['counts']}, expected {want} (the step's {plain['counts']})")
    if not abs(rem["loss"] - plain["loss"]) <= 1e-6 * abs(plain["loss"]):
        raise AssertionError(f"remat loss {rem['loss']!r} vs {plain['loss']!r}")
    worst, worst_noise = 0.0, 0.0
    for n, g in plain["grads"].items():
        scale = max(float(g.abs().max()), 1e-30)
        err = float((rem["grads"][n] - g).abs().max())
        noise = float((repeat["grads"][n] - g).abs().max())
        tol = REMAT_RTOL * scale if dtype is None else REMAT_BF16_ULPS * float(bf16_ulp(g.abs().max()))
        if not err <= tol:
            raise AssertionError(f"remat gradient {n}: max abs diff {err:.3e}, max|g| {scale:.3e}, the step "
                                 f"against a second run of it {noise:.3e}")
        worst, worst_noise = max(worst, err / scale), max(worst_noise, noise / scale)
    del repeat
    for run in runs.values():
        del run["grads"]
    samples = {False: [], True: []}
    for turn in range(REMAT_TURNS + 1):  # the first turn warms up
        for remat in ((False, True) if turn % 2 else (True, False)):
            run = runs[remat]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run["state"], _ = run["step"](run["state"], *batch)
            torch.cuda.synchronize()
            if turn:
                samples[remat].append((time.perf_counter() - t0) * 1e3)
    peak = {r: peak_memory(dev, lambda r=r: runs[r]["step"](runs[r]["state"], *batch)) for r in (False, True)}
    stats = {r: np.percentile(samples[r], [50, 90]) for r in (False, True)}
    what = f"piv v{version} {'bf16' if dtype is not None else 'float32'}"
    kept = ""
    if dtype is None:
        kept = "; kept by the train forward for the backward: " + ", ".join(
            f"{'remat' if r else 'without'} {forward_memory(runs[r]['state'].model, batch, r):.3f} GiB"
            for r in (True, False))
    log(f"  remat step {what} {TRAIN_H}^2 b{TRAIN_B}: launches {rem['counts']} (without remat {plain['counts']}); "
        f"loss {rem['loss']!r} vs {plain['loss']!r}; gradients worst max|dg|/max|g| {worst:.3e} "
        f"(tolerance {REMAT_RTOL if dtype is None else f'{REMAT_BF16_ULPS} bf16 ulps of max|g|'}); the step against "
        f"a second run of it {worst_noise:.3e}")
    log(f"    ms/step median / p90 of {REMAT_TURNS} in turns: remat {stats[True][0]:.3f} / {stats[True][1]:.3f}, "
        f"without {stats[False][0]:.3f} / {stats[False][1]:.3f} (x{stats[True][0] / stats[False][0]:.3f}); peak "
        f"memory of a step remat {peak[True]:.3f} GiB, without {peak[False]:.3f} GiB "
        f"(x{peak[True] / peak[False]:.3f}){kept}  ({card})")
    out = {"launches": rem["counts"], "ms": stats[True][0], "ms_plain": stats[False][0], "peak": peak[True],
           "peak_plain": peak[False]}
    if version == 1 and dtype is None:
        out["state"], out["step"], out["batch"] = runs[True]["state"], runs[True]["step"], batch
    return out


def forward_memory(model, batch, remat: bool) -> float:
    """GiB the float32 train forward of ``batch`` leaves allocated (what autograd keeps for the
    backward, and the outputs)."""
    from piv_liteflownet_tpu_torch.inference import to_nchw
    from piv_liteflownet_tpu_torch.ops.nn import f32_convs

    x1, x2 = (to_nchw(a, a.device) for a in batch[:2])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with f32_convs():
        out = model(x1, x2, train=True, remat=remat)
    torch.cuda.synchronize()
    kept = (torch.cuda.memory_allocated() - base) / 2**30
    del out
    return kept


def check_trace(state, step, batch) -> None:
    """``utils/profiling.trace`` around two float32 remat steps: the Chrome trace it writes must
    name every kernel of ``TRACE_KERNELS``."""
    from piv_liteflownet_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as tdir:
        (prof, printed) = quiet(lambda: _traced_steps(profiling, tdir, state, step, batch))
        trace = json.loads(Path(prof.trace_path).read_text())
        size = Path(prof.trace_path).stat().st_size
    kernels = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    missing = [k for k in TRACE_KERNELS if not any(k in name for name in kernels)]
    if missing:
        raise AssertionError(f"the trace of two remat steps names no {missing}: {sorted(set(kernels))[:20]}")
    log(f"  profiling.trace around two remat steps: {size / 2**20:.2f} MiB Chrome trace, {len(kernels)} kernel "
        f"events, {sum(any(k in name for k in TRACE_KERNELS) for name in kernels)} of them the port's "
        f"({', '.join(TRACE_KERNELS)})")


def _traced_steps(profiling, tdir, state, step, batch):
    with profiling.trace(tdir) as prof:
        for _ in range(2):
            state, _ = step(state, *batch)
    return prof


def run_optimizers(dev, ops, tmp: Path) -> None:
    """Two steps of each of the port's own optimizers on the card against the same steps on the
    CPU from the same gradients (``OPT_ATOL``); ``trainer --optimizer X`` for an epoch of phase 6's
    small directory (Novograd two, with backups); ``--resume`` of the Novograd run from its
    ``backup_1``: its first loss bit-equal to the unbroken run's epoch 2, its count carried."""
    from piv_liteflownet_tpu_torch import piv_liteflownet
    from piv_liteflownet_tpu_torch.training.optim import make_optimizer

    errs = {}
    for name in OWN_OPTIMIZERS:
        models = {d: piv_liteflownet(version=1, seed=0, device=d) for d in (dev, "cpu")}
        opts = {d: make_optimizer(m, 1, optimizer=name) for d, m in models.items()}
        rng = np.random.default_rng(31)
        grads = {n: 1e-2 * rng.standard_normal(p.shape).astype(np.float32)
                 for n, p in models["cpu"].named_parameters()}
        for _ in range(2):  # the same gradients twice: Lion's sign then has no near-zero argument
            for d, m in models.items():
                for n, p in m.named_parameters():
                    p.grad = torch.from_numpy(grads[n]).to(p.device)
                opts[d].step()
        errs[name] = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in
                         zip(models[dev].parameters(), models["cpu"].parameters()))
        counts = {float(st["count"]) for st in opts[dev].state.values()}
        if not errs[name] <= OPT_ATOL or counts != {2.0}:
            raise AssertionError(f"{name}: card vs CPU {errs[name]:.3e} (tolerance {OPT_ATOL}), counts {counts}")
    log(f"  two steps of each optimizer, card vs CPU from the same gradients, max abs diff of the params: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tolerance {OPT_ATOL})")

    root, cli = tmp / "data", tmp / "cli_opt"
    steps = len(json.loads((root / "train.json").read_text())) // TRAIN_B
    runs = {}
    for name in OWN_OPTIMIZERS:
        epochs = 2 if name == "Novograd" else 1
        tr, counts, secs = run_cli(ops, root, cli / name, "--optimizer", name, "--total_epochs", str(epochs),
                                   "--backup_frequency", "1", "--validation_dataset_mode", "none")
        losses = logged_losses(tr, "train_batch")
        want = cli_counts(epochs * steps, 0, bf16=False)
        if type(tr.state.optimizer).__name__ != name or counts != want or len(losses) != epochs * steps \
                or not all(np.isfinite([v for _, v in losses])):
            raise AssertionError(f"trainer --optimizer {name}: {type(tr.state.optimizer).__name__}, launches "
                                 f"{counts} (expected {want}), losses {losses}")
        runs[name] = (losses, secs)
    resumed, _, _ = run_cli(ops, root, cli / "Novograd_resumed", "--optimizer", "Novograd", "--total_epochs", "2",
                            "--validation_dataset_mode", "none", "--resume", str(cli / "Novograd" / "backup_1"))
    r_losses, u_losses = logged_losses(resumed, "train_batch"), runs["Novograd"][0]
    counts = {float(st["count"]) for st in resumed.state.optimizer.state.values()}
    if not r_losses or r_losses[0] != u_losses[steps] or counts != {2.0 * steps}:
        raise AssertionError(f"Novograd resume: {r_losses} vs the unbroken run's epoch 2 {u_losses[steps:]}, "
                             f"counts {counts}")
    log(f"  trainer --optimizer X, piv v1 b{TRAIN_B} crop {TRAIN_H}^2, {steps} steps an epoch: "
        + "; ".join(f"{k} losses {[round(v, 6) for _, v in ls]} ({s:.2f} s)" for k, (ls, s) in runs.items()))
    log(f"  --resume of the Novograd run from backup_1: first loss {r_losses[0][1]!r} equals the unbroken run's "
        f"epoch 2 bit for bit; count {2 * steps} after epoch 2")


def run_postpro(dev) -> None:
    """``calc_vorticity`` and ``de_vort`` of the trained v1 weights' evalset flows on the card
    against the same functions on the CPU on the same flows (``POSTPRO_ATOL``)."""
    from piv_liteflownet_tpu_torch import piv_liteflownet, postpro
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.models.factory import PIV_V1
    from piv_liteflownet_tpu_torch.utils.checkpoint import load_params_npz

    repo = Path(__file__).resolve().parent
    model = piv_liteflownet(load_params_npz(PIV_V1, str(repo / TRAINED[1][0])), version=1)
    _, im1, im2, _ = read_evalset(repo / EVALSET)
    flows = estimate(model, im1, im2)
    errs = {}
    for name in ("calc_vorticity", "de_vort"):
        for calib in (1.0, 0.37):
            got = getattr(postpro, name)(flows, calib=calib)
            want = getattr(postpro, name)(flows.cpu(), calib=calib)
            errs[f"{name} calib {calib}"] = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
            if got[0].device != flows.device or got[0].shape != flows.shape[:3]:
                raise AssertionError(f"{name}: {got[0].device} {tuple(got[0].shape)}")
    if not max(errs.values()) <= POSTPRO_ATOL:
        raise AssertionError(f"postpro card vs CPU {errs} (tolerance {POSTPRO_ATOL})")
    log(f"  postpro of the trained v1 weights' {len(flows)} evalset flows {tuple(flows.shape[1:3])}, card vs CPU, "
        f"max abs diff: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tolerance {POSTPRO_ATOL})")


def save_grey(im: torch.Tensor, path: Path) -> None:
    """An ``[H,W,3]`` frame in [0, 1] as an 8-bit grey PNG, as ``make_dataset_dir`` writes them."""
    from PIL import Image

    Image.fromarray((im[..., 0] * 255).to(torch.uint8).cpu().numpy()).save(path)


def render_stereo_pairs(dev, root: Path, n: int, size: int, seed: int) -> None:
    """``n`` stereo PIV pairs ``root/{left,right}/s<i>-{L,R}_img{1,2}.png``: the same particles
    (``data/piv_gen``) moved by (1.5, 0.5) px in the left view and (-1.5, 0.5) in the right."""
    from piv_liteflownet_tpu_torch.data.piv_gen import ParticleImageGen, uniform_flow

    gen = ParticleImageGen(image_size=(size, size))
    generator = torch.Generator().manual_seed(seed)
    for cam in ("left", "right"):
        (root / cam).mkdir(parents=True)
    for i in range(n):
        parts = gen.sample_particles(generator, dev)
        for cam, tag, u in (("left", "L", 1.5), ("right", "R", -1.5)):
            im1, im2 = gen.advect(parts, uniform_flow(size, size, u, 0.5, device=dev))
            save_grey(im1, root / cam / f"s{i:02d}-{tag}_img1.png")
            save_grey(im2, root / cam / f"s{i:02d}-{tag}_img2.png")


def numpy_reconstruct(flows, coeff: dict, theta, beta, fps, calib) -> np.ndarray:
    """The JAX package's stereo arithmetic in numpy on the host (``_stereo_cal`` and ``willert``):
    the reference for ``stereo_run.reconstruct`` and its time."""
    def nl(x, y, A):
        A = np.asarray(A, np.float64)
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        x2, y2, xy = x * x, y * y, x * y
        return ((A[0] * x + A[1] * y + A[2] + A[3] * x2 + A[4] * y2 + A[5] * xy)
                / (A[6] * x + A[7] * y + A[8] + A[9] * x2 + A[10] * y2 + A[11] * xy),
                (A[12] * x + A[13] * y + A[14] + A[15] * x2 + A[16] * y2 + A[17] * xy)
                / (A[18] * x + A[19] * y + A[20] + A[21] * x2 + A[22] * y2 + A[23] * xy))

    cal = []
    for f, cam in zip(flows, ("Left", "Right")):
        u, v = nl(f[:, :, 0], f[:, :, 1], coeff[cam])
        fs = np.dstack([u, v]).astype(np.float32)
        cal.append(fs * calib * fps if calib else fs)
    u, v = [f[:, :, 0] for f in cal], [f[:, :, 1] for f in cal]
    t0, t1 = np.tan(theta[0]), np.tan(theta[1])
    b0, b1 = np.tan(beta[0]), np.tan(beta[1])
    return np.dstack([(u[1] * t0 - u[0] * t1) / (t0 - t1),
                      (v[0] + v[1]) / 2 + (u[1] - u[0]) * (b1 - b0) / (t0 - t1) / 2,
                      (u[1] - u[0]) / (t0 - t1)]).astype(np.float32)


def run_calibration(tmp: Path) -> Path:
    """``stereo_cal --clicks`` on a synthetic 1024^2 left and right plate (``calibration_plate``:
    crosses every 40 px under ``plate_distortion``, grey noise 8) on the card and with ``--cpu``:
    the same cross counts, the centres, and the mappings of the grid points within ``CAL_ATOL``.
    Returns the card's coefficient file."""
    from PIL import Image

    from piv_liteflownet_tpu_torch import stereo_cal
    from piv_liteflownet_tpu_torch.stereo.dewarp import nl_trans
    from piv_liteflownet_tpu_torch.utils.synthetic import calibration_plate

    plates = tmp / "plates"
    plates.mkdir()
    for tag, shift, seed in (("-L", 3.0, 41), ("-R", -3.0, 42)):
        img, centres = calibration_plate(PLATE_SIZE, PLATE_SIZE, PLATE_PITCH, plate_distortion(shift),
                                         noise=8.0, seed=seed)
        Image.fromarray(img).save(plates / f"plate{tag}.png")
    # one cell of the grid near the centre, clockwise from its top left
    cols = len(np.unique(centres[:, 0]))
    first = (len(centres) // 2 // cols) * cols + cols // 2
    cell = [centres[first], centres[first + 1], centres[first + cols + 1], centres[first + cols]]
    argv = ["--root", str(plates), "--name", "plate", "--clicks", *(str(c) for xy in cell for c in xy),
            "--calib", "0.002"]
    got, secs = {}, {}
    for where, extra in (("card", ()), ("cpu", ("--cpu",))):
        t0 = time.perf_counter()
        got[where], _ = quiet(stereo_cal.main, argv + ["--save", str(tmp / f"cal_{where}"), *extra])
        secs[where] = time.perf_counter() - t0
    report = []
    for cam in ("Left", "Right"):
        (c_card, new_pts, pt1), (c_cpu, _, _) = got["card"]["points"][cam], got["cpu"]["points"][cam]
        if len(c_card) != len(c_cpu) or len(c_card) < 0.9 * len(centres):
            raise AssertionError(f"{cam}: {len(c_card)} crosses on the card, {len(c_cpu)} on the CPU, "
                                 f"{len(centres)} on the plate")
        centre_err = float(np.abs(c_card - c_cpu).max())
        rel = new_pts - new_pts[pt1]
        mx, my = nl_trans(rel[:, 0], rel[:, 1], got["card"][cam])
        jx, jy = nl_trans(rel[:, 0], rel[:, 1], got["cpu"][cam])
        map_err = float(torch.hypot(mx - jx, my - jy).max())
        if not (centre_err <= 1e-3 and map_err <= CAL_ATOL):
            raise AssertionError(f"{cam}: centres card vs CPU {centre_err:.3e} px, mappings {map_err:.3e} px "
                                 f"(tolerances 1e-3, {CAL_ATOL})")
        report.append(f"{cam} {len(c_card)} crosses, centres max diff {centre_err:.3e} px, mappings {map_err:.3e} px")
    log(f"  stereo_cal --clicks, two {PLATE_SIZE}^2 plates of {len(centres)} crosses: card {secs['card']:.2f} s, "
        f"--cpu {secs['cpu']:.2f} s; card vs CPU: " + "; ".join(report) + f" (tolerance {CAL_ATOL})")
    return tmp / "cal_card" / "plate_coeff.json"


def run_stereo(dev, ops, card, tmp: Path, coeff: Path) -> dict:
    """``stereo_run`` with the trained v1 weights: ``direct`` on ``STEREO_N`` 1024^2 stereo pairs
    with the calibration's coefficients (launches counted: two estimates a pair), its pairs/s
    beside twice ``estimate`` alone and the card's idle share between estimates; ``manual``
    on the same pairs within ``STEREO_ATOL``; identical views with identity coefficients and
    theta +-45: W exactly 0, U and V ``estimate``'s flow; one 256^2 pair card vs ``--cpu``
    within ``STEREO_CPU_ATOL``; ``reconstruct`` on the card beside the same arithmetic in numpy on
    the host. Returns the launches of the direct run."""
    from piv_liteflownet_tpu_torch import piv_liteflownet, stereo_run
    from piv_liteflownet_tpu_torch.models.factory import PIV_V1
    from piv_liteflownet_tpu_torch.run import load_image
    from piv_liteflownet_tpu_torch.utils.checkpoint import load_params_npz
    from piv_liteflownet_tpu_torch.utils.flow_io import read_flow

    weights = str(Path(__file__).resolve().parent / TRAINED[1][0])
    root = tmp / "stereo_pairs"
    render_stereo_pairs(dev, root, STEREO_N, STEREO_SIZE, seed=43)
    argv = ["--coeff", str(coeff), "--root", str(root), "--model", weights, "--theta", "45", "--calib", "0.001",
            "--fps", "50"]
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    with EstimateEvents(stereo_run) as ev:
        direct, _ = quiet(stereo_run.main, argv + ["--save", str(tmp / "st_direct"), "--inference-mode", "direct"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts(ops)
    want = forward_counts((6, 11, 6, 0), 2 * STEREO_N, bf16=False)
    if counts != want or len(direct) != STEREO_N:
        raise AssertionError(f"stereo_run direct launches {counts} (expected {want}), files {direct}")
    idle_ms, idle = idle_share(ev.events)
    t0 = time.perf_counter()
    manual, _ = quiet(stereo_run.main, argv + ["--save", str(tmp / "st_manual")])
    manual_s = time.perf_counter() - t0
    err = max(float(np.abs(read_flow(a, use_stereo=True) - read_flow(b, use_stereo=True)).max())
              for a, b in zip(direct, manual))
    outs = [read_flow(a, use_stereo=True) for a in direct]
    if [Path(p).name for p in direct] != [Path(p).name for p in manual] or not err <= STEREO_ATOL \
            or not all(np.isfinite(o).all() and o.shape == (STEREO_SIZE, STEREO_SIZE, 3) for o in outs):
        raise AssertionError(f"stereo_run direct vs manual {err:.3e} px (tolerance {STEREO_ATOL}): {direct} {manual}")

    model = piv_liteflownet(load_params_npz(PIV_V1, weights), version=1)
    l1, l2 = (torch.from_numpy(load_image(str(root / "left" / f"s00-L_img{k}.png"))).to(dev) for k in (1, 2))
    est_ms = median_ms(lambda: stereo_run.estimate(model, l1, l2, tensor=True), 10)
    log(f"  stereo_run direct, {STEREO_N} stereo pairs {STEREO_SIZE}^2, trained v1 weights, the calibration's "
        f"coefficients: {secs:.2f} s, {STEREO_N / secs:.3f} stereo pairs/s; launches {counts}; the card idle "
        f"between estimates {idle_ms:.1f} ms, {100 * idle:.1f} % of the span; two estimates alone "
        f"{2 * est_ms:.3f} ms per stereo pair ({1e3 / (2 * est_ms):.3f} pairs/s); manual {manual_s:.2f} s, "
        f"its files within {err:.3e} px of direct's (tolerance {STEREO_ATOL}); |U,V,W| max "
        f"{max(float(np.abs(o).max()) for o in outs):.4f}  ({card})")

    # reconstruction alone: on the card beside the same arithmetic in numpy on the host
    coeffs = json.loads(coeff.read_text())
    args = stereo_run.build_parser().parse_args(argv)
    theta, beta = stereo_run._angles(args)
    calib = stereo_run._calib(coeffs, args)
    r1, r2 = (torch.from_numpy(load_image(str(root / "right" / f"s00-R_img{k}.png"))).to(dev) for k in (1, 2))
    flows = [stereo_run.estimate(model, a, b, tensor=True)[0] for a, b in ((l1, l2), (r1, r2))]
    host = [f.cpu().numpy() for f in flows]

    def on_card():
        return stereo_run.reconstruct(flows, coeffs, theta, beta, args.fps, calib)

    got = on_card().cpu().numpy()
    ref = numpy_reconstruct(host, coeffs, theta, beta, args.fps, calib)
    ulps = int(np.max(np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))))
    card_ms = median_ms(on_card, 20)
    t0 = time.perf_counter()
    for _ in range(5):
        numpy_reconstruct(host, coeffs, theta, beta, args.fps, calib)
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    if ulps > 1:
        raise AssertionError(f"reconstruct on the card is {ulps} float32 ulps from numpy's")
    log(f"  reconstruct (dewarp float64, scaling, Willert float64) of one {STEREO_SIZE}^2 stereo pair: card "
        f"{card_ms:.3f} ms (synchronised, median of 20), numpy on the host {host_ms:.3f} ms (mean of 5); card vs "
        f"numpy within {ulps} float32 ulp  ({card})")

    # identical views, identity coefficients, theta +-45: W = 0, (U, V) = estimate's flow
    ident = tmp / "stereo_ident"
    for cam, tag in (("left", "L"), ("right", "R")):
        (ident / cam).mkdir(parents=True)
        for i in range(2):
            for k in (1, 2):
                (ident / cam / f"s{i:02d}-{tag}_img{k}.png").write_bytes(
                    (root / "left" / f"s{i:02d}-L_img{k}.png").read_bytes())
    identity = [0.0] * 24
    identity[0] = identity[8] = identity[13] = identity[20] = 1.0
    (ident / "coeff.json").write_text(json.dumps({"Left": identity, "Right": identity}))
    files, _ = quiet(stereo_run.main, ["--coeff", str(ident / "coeff.json"), "--root", str(ident), "--model", weights,
                                       "--theta", "45", "--save", str(tmp / "st_ident"), "--inference-mode", "direct"])
    for i, path in enumerate(files):
        out = read_flow(path, use_stereo=True)
        a, b = (torch.from_numpy(load_image(str(ident / "left" / f"s{i:02d}-L_img{k}.png"))).to(dev) for k in (1, 2))
        flow = stereo_run.estimate(model, a, b, tensor=True)[0].cpu().numpy()
        if not (np.array_equal(out[..., 2], np.zeros_like(out[..., 2])) and np.array_equal(out[..., :2], flow)):
            raise AssertionError(f"identical views {path}: max |W| {np.abs(out[..., 2]).max()}, "
                                 f"max |UV - flow| {np.abs(out[..., :2] - flow).max()}")
    log(f"  identical views, identity coefficients, theta +-45 ({len(files)} pairs): W exactly 0, U and V "
        f"bit-equal to estimate's flow")

    # one small pair, the card against --cpu
    small = tmp / "stereo_small"
    render_stereo_pairs(dev, small, 1, 256, seed=44)
    small_argv = ["--coeff", str(coeff), "--root", str(small), "--model", weights, "--theta", "40", "35",
                  "--alpha", "2", "--inference-mode", "direct"]
    (c_files, _), (p_files, _) = (quiet(stereo_run.main, small_argv + ["--save", str(tmp / f"st_small_{w}"), *x])
                                  for w, x in (("card", ()), ("cpu", ("--cpu",))))
    small_err = float(np.abs(read_flow(c_files[0], use_stereo=True) - read_flow(p_files[0], use_stereo=True)).max())
    if not small_err <= STEREO_CPU_ATOL:
        raise AssertionError(f"stereo_run 256^2 card vs CPU {small_err:.3e} px (tolerance {STEREO_CPU_ATOL})")
    log(f"  stereo_run direct, one 256^2 stereo pair, card vs --cpu: max abs diff {small_err:.3e} px "
        f"(tolerance {STEREO_CPU_ATOL})")
    return counts


def median_ms(fn, iters: int) -> float:
    """Median ms of ``iters`` synchronised calls of ``fn`` after 2 warm-up calls (host clock)."""
    for _ in range(2):
        fn()
    samples = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def run_extras(dev, ops, card, tmp: Path) -> dict:
    """Phase 8: the remat step (``remat_case`` for piv v1 and v2, float32 and bf16), a profiler trace
    of it, the port's own optimizers (``run_optimizers``), post-processing (``run_postpro``), stereo
    calibration (``run_calibration``) and reconstruction (``run_stereo``). Needs phase 6's
    directory in ``tmp``. Returns the launches of the remat steps and of ``stereo_run``."""
    paths = {}
    for version, dtype in REMAT_CASES:
        case = remat_case(dev, ops, card, version, dtype)
        if version == 1:
            paths[PATH_REMAT if dtype is None else PATH_REMAT_BF16] = case["launches"]
        if "state" in case:
            check_trace(case["state"], case["step"], case["batch"])
        del case
    run_optimizers(dev, ops, tmp)
    run_postpro(dev)
    coeff = run_calibration(tmp)
    paths[PATH_STEREO] = run_stereo(dev, ops, card, tmp, coeff)
    return paths


# -- phase 9: multi-GPU -----------------------------------------------------------------------
MULTI_RANKS = 2  # two ranks over gloo on the one card: NCCL refuses two ranks on one device
SPATIAL_H, SPATIAL_W = 2048, 1024
#: px: the spatial estimate against the unsharded call, or, where larger, twice the unsharded float32
#: call's own distance from its float64 plain-ops twin (a warp's float32 sample row at 2048 rows
#: rounds to half an ulp of 2048, 1.2e-4 px; a slab's row is smaller), and in bf16 the unsharded bf16
#: call's distance from the float32 one
SPATIAL_ATOL = 1e-4
DP_STEPS = 5  # timed steps of each rank; 2 more warm up
SPATIAL_ITERS = 3  # timed spatial estimates of each variant; one more warms up
DP_CLI_PAIRS = 8  # run --num_devices 2 over the first pairs of phase 7's directory
FALLBACK_V = 40.0  # px: one v beyond the halo (32) in rank 1's rows alone
SPATIAL_VARIANTS = (("float32", "cudnn"), ("float32", "chain"), ("bf16", "cudnn"), ("bf16", "chain"))
PATH_NCCL1 = "train step + estimate, mesh of 1 rank (NCCL), piv v1"
PATH_DP = "data-parallel train step piv v1 256^2 b8, 2 gloo ranks on one card (per rank)"
PATH_DP_BF16 = "data-parallel train step piv v1 256^2 b8 bf16, 2 gloo ranks on one card (per rank)"
PATH_DP_CLI = "trainer --number_devices 2 rank loop piv v1 256^2 b8, 1 epoch (per rank)"
PATH_DP_RUN = "run --num_devices 2 rank function, 8 pairs 1024^2 b2 (per rank)"
PATH_SPATIAL = "spatial estimate piv v1 2048x1024, 2 gloo ranks on one card (per rank)"


def launched(counts: dict) -> dict:
    """The entry points of ``counts`` that launched."""
    return {k: v for k, v in counts.items() if v}


def dp_batch(dev):
    """Phase 5's training batch: piv v1 256^2 b8 particle pairs shifted by (2.5, -1.5) px."""
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    shift = (2.5, -1.5)
    im1, im2 = particle_pair(TRAIN_B, TRAIN_H, TRAIN_W, seed=20, shift=shift)
    target = np.empty((TRAIN_B, TRAIN_H, TRAIN_W, 2), np.float32)
    target[...] = shift
    return tuple(torch.from_numpy(a).to(dev) for a in (im1, im2, target))


def dp_step_run(dev, ops, mesh, batch, dtype, steps: int = DP_STEPS) -> dict:
    """piv v1 (seed 0) and Adam: one step with the counts set to 0 around it (loss, gradients,
    launches), then ``steps`` timed steps after 2 more (ms each, peak memory)."""
    from piv_liteflownet_tpu_torch import piv_liteflownet
    from piv_liteflownet_tpu_torch.parallel.mesh import shard_rows
    from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_train_step
    from piv_liteflownet_tpu_torch.training.loss import piv_loss
    from piv_liteflownet_tpu_torch.training.optim import make_optimizer

    model = piv_liteflownet(version=1, seed=0, device=dev)
    opt = make_optimizer(model, model.cfg.lowest_level)
    step = make_train_step(model.cfg, piv_loss(), opt, mesh=mesh, compute_dtype=dtype)
    state = TrainState(model, opt)
    mine = tuple(shard_rows(mesh, a) for a in batch) if mesh is not None else batch
    torch.cuda.synchronize()
    reset_counts(ops)
    state, metrics = step(state, *mine)
    torch.cuda.synchronize()
    out = {"counts": read_counts(ops), "loss": float(metrics["loss"]), "epe": float(metrics["epe"]),
           "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()}}
    state, _, samples, peak = steps_on_one_batch(dev, step, state, mine, steps)
    out.update(ms=samples, peak_gib=peak / 2**30)
    return out


def spatial_frames(dev):
    """A 2048x1024 particle pair shifted by (2.5, -1.5) px, NHWC on ``dev``."""
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    im1, im2 = particle_pair(1, SPATIAL_H, SPATIAL_W, seed=31)
    return torch.from_numpy(im1).to(dev), torch.from_numpy(im2).to(dev)


def spatial_model(dev, dtype: str, impl: str):
    """piv v1 with the tracked trained weights, in ``dtype``, NetE stacks through ``impl``."""
    from types import SimpleNamespace

    from piv_liteflownet_tpu_torch import piv_liteflownet
    from piv_liteflownet_tpu_torch.models.factory import config
    from piv_liteflownet_tpu_torch.run import load_weights

    root = Path(__file__).resolve().parent
    state, _ = load_weights(SimpleNamespace(params=str(root / TRAINED[1][0]), model="piv"), config("piv", 1))
    model = piv_liteflownet(state, version=1, device=dev, conv_impl=impl)
    return model.to(torch.bfloat16) if dtype == "bf16" else model


def spatial_run(dev, ops, t1, t2, dtype: str, impl: str, spatial_mesh=None) -> dict:
    """One estimate with the counts set to 0 around it (its flow, launches, traffic, peak memory),
    then ``SPATIAL_ITERS`` timed ones after a warm-up."""
    from piv_liteflownet_tpu_torch.inference import estimate

    model = spatial_model(dev, dtype, impl)
    call = lambda: estimate(model, t1, t2, tensor=True, spatial_mesh=spatial_mesh)  # noqa: E731
    torch.cuda.synchronize()
    if spatial_mesh is not None:
        spatial_mesh.traffic.reset()
    reset_counts(ops)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    flow = call().float()
    torch.cuda.synchronize()
    out = {"flow": flow, "counts": read_counts(ops), "peak_gib": (torch.cuda.max_memory_allocated(dev) - base) / 2**30}
    if spatial_mesh is not None:
        tr = spatial_mesh.traffic
        out.update(sent=tr.halo_sent, received=tr.halo_received, exchanges=len(tr.halo),
                   gathers=sorted({g[0] for g in tr.gathers}), gather_bytes=sum(g[1] for g in tr.gathers),
                   bound_ok=all(r[5] <= (r[1] + r[2]) * r[3] for r in tr.halo))
    call()
    samples = []
    for _ in range(SPATIAL_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = samples
    return out


def multi_gpu_rank(mesh, work: dict) -> dict:
    """Phase 9 on one of two ranks sharing the card over gloo: the data-parallel step (float32 and
    bf16) held to the one-process step's loss and gradients (``work``'s files), the trainer's rank
    loop and ``run``'s rank function, the spatial estimates held to the unsharded ones, and the
    warp's fallback. Returns what it measured; raises on a mismatch."""
    import contextlib
    import dataclasses

    from piv_liteflownet_tpu_torch import run, trainer
    from piv_liteflownet_tpu_torch.ops import conv_chain, correlation, rgb_warp, warp
    from piv_liteflownet_tpu_torch.parallel.mesh import Traffic, all_gather, split_rows
    from piv_liteflownet_tpu_torch.parallel.ctx import SpatialCtx
    from piv_liteflownet_tpu_torch.parallel.spatial import spatial_backwarp
    from piv_liteflownet_tpu_torch.training.precision import grad_relation

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops = (correlation, warp, rgb_warp, conv_chain)
    dev = mesh.device
    out = {"rank": mesh.rank, "backend": mesh.backend, "staged": sorted(
        c for c in ("all_reduce", "broadcast", "all_gather", "p2p") if mesh.staged(c))}
    refs = torch.load(work["refs"], map_location=dev, weights_only=True)
    batch = dp_batch(dev)
    for tag, dtype in (("float32", None), ("bf16", torch.bfloat16)):
        got = dp_step_run(dev, ops, mesh, batch, dtype)
        want, truth = refs[f"dp {tag}"], refs["dp float32"]
        if tag == "float32":
            # cuDNN picks its algorithms by batch (4 rows against 8): phase 5's tolerance for two float32
            # steps summed in other orders, each element within 1e-4 of max|g| + 1e-3 of itself
            bad = [n for n, g in want.items() if not bool(((got["grads"][n] - g).abs() <= GRAD_ATOL_REL
                                                           * g.abs().max() + GRAD_RTOL * g.abs()).all())]
            worst = max((float((got["grads"][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30), n)
                        for n, g in want.items())
            if bad or not abs(got["loss"] - float(refs["loss float32"])) <= 1e-5 * abs(got["loss"]):
                raise AssertionError(f"rank {mesh.rank}: the float32 data-parallel step's gradients {bad} beyond "
                                     f"the tolerance (worst {worst}), loss {got['loss']!r}")
            rel = None
        else:
            worst = max(float((got["grads"][n] - g).abs().max() / bf16_ulp(g.abs().max())) for n, g in want.items())
            rel = grad_relation(got["grads"], want, truth)
            if any(err > bound for err, _, bound in rel.values()):
                raise AssertionError(f"rank {mesh.rank}: the bf16 data-parallel step's gradients {rel}")
        if got["counts"] != work["dp counts"][tag]:
            raise AssertionError(f"rank {mesh.rank}: the {tag} data-parallel step launched {got['counts']}, one "
                                 f"process's step {work['dp counts'][tag]}")
        out[f"dp {tag}"] = dict(loss=got["loss"], counts=got["counts"], ms=got["ms"], peak_gib=got["peak_gib"],
                                worst=worst, relation=rel)
        del got
    # the trainer's rank loop and run's rank function, as the CLIs spawn them
    with open(Path(work["tmp"]) / f"dp_cli_rank{mesh.rank}.txt", "w") as f, contextlib.redirect_stdout(f):
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        out["cli"] = trainer.train_rank(mesh, work["cli_argv"])
        torch.cuda.synchronize()
        out["cli"].update(counts=read_counts(ops), seconds=time.perf_counter() - t0)
        reset_counts(ops)
        t0 = time.perf_counter()
        stats = run.run_rank(mesh, work["run_argv"])
        torch.cuda.synchronize()
        out["run"] = dict(pairs=stats[0].pairs, counts=read_counts(ops), seconds=time.perf_counter() - t0)
    # spatial estimates: the same ranks as a spatial mesh
    smesh = dataclasses.replace(mesh, axis="spatial", traffic=Traffic())
    t1, t2 = spatial_frames(dev)
    for dtype, impl in SPATIAL_VARIANTS:
        key = f"{dtype} {impl}"
        got = spatial_run(dev, ops, t1, t2, dtype, impl, smesh)
        err = float((got.pop("flow") - refs[f"spatial {key}"]).abs().max())
        tol = work["spatial tol"][key]
        got.update(max_abs_err=err, tol=tol)
        out[f"spatial {key}"] = got
        sfx = "" if dtype == "float32" else "_bf16"
        if not (got["counts"]["corr49" + sfx] and got["counts"]["backwarp" + sfx] and not got["counts"]["rgb_warp_norm" + sfx]
                and bool(got["counts"]["conv_chain" + sfx]) == (impl == "chain")):
            raise AssertionError(f"rank {mesh.rank}: spatial estimate {key} launched {launched(got['counts'])}: "
                                 "K1 and K4 on slabs, K6 with the chain, no K3 (its warp is K4's halo warp)")
        if not (err <= tol and got["bound_ok"] and got["gathers"] in (["output"], ["output", "warp gather"])):
            raise AssertionError(f"rank {mesh.rank}: spatial estimate {key}: {got} (tolerance {tol})")
    # the warp's fallback: a v beyond the halo in rank 1's rows alone sends both ranks to the gather
    img = randn((1, 32, SPATIAL_H // 2, SPATIAL_W // 2), 90, dev)
    flow = smooth_flow(1, SPATIAL_H // 2, SPATIAL_W // 2, dev)
    flow[0, 1, SPATIAL_H // 4 + 5, 7] = FALLBACK_V
    rows = split_rows(img.shape[2], mesh.size, mesh.rank)
    smesh.traffic.reset()
    got = spatial_backwarp(SpatialCtx(smesh), img[:, :, rows].contiguous(), flow[:, :, rows].contiguous(), 1,
                           warp.backwarp)
    whole = all_gather(smesh, got, 2)
    err = float((whole - warp.backwarp(img, flow)).abs().max())
    out["fallback"] = dict(gathers=[g[0] for g in smesh.traffic.gathers], max_abs_err=err)
    if out["fallback"]["gathers"] != ["warp fallback"] or not err <= WARP_ATOL:
        raise AssertionError(f"rank {mesh.rank}: the forced fallback {out['fallback']}")
    return out


def run_multi_gpu(dev, ops, card, tmp: Path) -> dict:
    """Phase 9. On the card alone: a mesh of one rank (NCCL) under the train step and ``estimate``,
    equal to the calls without a mesh. Then two ranks over gloo share the card
    (``multi_gpu_rank``): NCCL refuses two ranks on one device, so NCCL between cards is not
    shown here. Times and memory of those ranks are of two processes on one card, never a
    multi-card number. Returns each path's launches (per rank, rank 0's)."""
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS
    from piv_liteflownet_tpu_torch.parallel.mesh import default_backend, make_mesh, spawn
    from piv_liteflownet_tpu_torch.utils.flow_io import read_flow

    t0 = time.perf_counter()
    batch = dp_batch(dev)
    mesh = make_mesh(1)
    try:
        if mesh.backend != default_backend(dev) or mesh.device.type != dev.type:
            raise AssertionError(f"a mesh of one rank on {dev}: {mesh}")
        plain = dp_step_run(dev, ops, None, batch, None, steps=0)
        meshed = dp_step_run(dev, ops, mesh, batch, None, steps=0)
        # two runs of a step differ in the order of the backward's atomics: 1e-5 of max|g|
        worst = max(float((meshed["grads"][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                    for n, g in plain["grads"].items())
        im1, im2 = batch[0][:2], batch[1][:2]
        model = spatial_model(dev, "float32", "cudnn")
        e_plain = estimate(model, im1, im2, tensor=True)
        e_mesh = estimate(model, im1, im2, tensor=True, mesh=mesh)
        e_err = float((e_plain - e_mesh).abs().max())
        if not (worst <= REMAT_RTOL and meshed["loss"] == plain["loss"] and e_err == 0.0
                and meshed["counts"] == plain["counts"]):
            raise AssertionError(f"NCCL world size 1: the mesh step or estimate differs from the calls without "
                                 f"a mesh (gradients {worst:.3e} of max|g|, loss {meshed['loss']!r} / "
                                 f"{plain['loss']!r}, estimate {e_err:.3e})")
        nccl_counts = meshed["counts"]
        log(f"  NCCL, one rank: the mesh train step's loss bit-equal to the step's without a mesh, every "
            f"gradient within {worst:.3e} of its max|g|; estimate(mesh) bit-equal to estimate "
            f"({launched(nccl_counts)})")
    finally:
        mesh.close()
    del plain, meshed

    refs = {"loss float32": None}
    one = {}
    for tag, dtype in (("float32", None), ("bf16", torch.bfloat16)):
        one[tag] = dp_step_run(dev, ops, None, batch, dtype)
        refs[f"dp {tag}"] = one[tag].pop("grads")
    refs["loss float32"] = torch.tensor(one["float32"]["loss"])
    t1, t2 = spatial_frames(dev)
    unsharded = {}
    for dtype, impl in SPATIAL_VARIANTS:
        got = spatial_run(dev, ops, t1, t2, dtype, impl)
        refs[f"spatial {dtype} {impl}"] = got.pop("flow")
        unsharded[f"{dtype} {impl}"] = got
    with torch.no_grad():
        f64 = spatial_model(dev, "float32", "cudnn").double()
        truth = estimate(f64, t1.double(), t2.double(), tensor=True, ops=PLAIN_OPS).float()
    del f64, t1, t2
    f32_err = {impl: float((refs[f"spatial float32 {impl}"] - truth).abs().max()) for impl in ("cudnn", "chain")}
    bf16_err = {impl: float((refs[f"spatial bf16 {impl}"] - refs["spatial float32 cudnn"]).abs().max())
                for impl in ("cudnn", "chain")}
    spatial_tol = {f"float32 {impl}": max(SPATIAL_ATOL, 2 * f32_err[impl]) for impl in f32_err}
    spatial_tol.update({f"bf16 {impl}": max(SPATIAL_ATOL, bf16_err[impl]) for impl in bf16_err})
    log(f"  unsharded {SPATIAL_H}x{SPATIAL_W}, max|flow| {float(truth.abs().max()):.3f} px: float32 from its float64 "
        f"plain-ops twin {f32_err}, bf16 from float32 {bf16_err}; the spatial tolerances {spatial_tol}")
    del truth
    refs_path = tmp / "multi_gpu_refs.pt"
    torch.save({k: (v.cpu() if isinstance(v, torch.Tensor) else {n: g.cpu() for n, g in v.items()})
                for k, v in refs.items()}, refs_path)
    del refs
    cli_common = ["--model", "LiteFlowNet", "--batch_size", str(TRAIN_B), "--crop_size", str(TRAIN_H), str(TRAIN_W),
                  "--training_dataset_root", str(tmp / "data"), "--validation_dataset_root", str(tmp / "data"),
                  "--total_epochs", "1"]
    one_cli, one_counts, one_s = run_cli(ops, tmp / "data", tmp / "dp_cli_one", "--total_epochs", "1")
    run_common = ["-m", "piv", "-p", "-i", str(tmp / "frames"), "-n", str(DP_CLI_PAIRS), "--batch_size", str(RUN_B),
                  "--params", str(Path(__file__).resolve().parent / TRAINED[1][0])]
    quiet(__import__("piv_liteflownet_tpu_torch.run", fromlist=["main"]).main,
          run_common + ["-o", str(tmp / "dp_run_one")])
    torch.cuda.empty_cache()
    log(f"  references in one process: {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    work = {"refs": str(refs_path), "tmp": str(tmp), "dp counts": {k: v["counts"] for k, v in one.items()},
            "spatial tol": spatial_tol,
            "cli_argv": cli_common + ["--save", str(tmp / "dp_cli_two"), "--logger_workdir", str(tmp / "dp_cli_two" / "exp")],
            "run_argv": run_common + ["-o", str(tmp / "dp_run_two"), "--num_devices", str(MULTI_RANKS)]}
    ranks = spawn(multi_gpu_rank, MULTI_RANKS, work, backend="gloo",
                  devices=[f"{dev.type}:0" if dev.type == "cuda" else "cpu"] * MULTI_RANKS, timeout_s=900)
    spawn_s = time.perf_counter() - t1
    r0 = ranks[0]
    log(f"  {MULTI_RANKS} ranks over {r0['backend']} on one card ({card}) in {spawn_s:.1f} s; collectives staged "
        f"through pinned host memory: {r0['staged']}")
    for tag in ("float32", "bf16"):
        o = one[tag]
        parts = []
        for r in ranks:
            d = r[f"dp {tag}"]
            parts.append(f"rank {r['rank']}: {np.median(d['ms']):.3f} ms/step median ({min(d['ms']):.3f}-"
                         f"{max(d['ms']):.3f}), peak {d['peak_gib']:.3f} GiB, launches {launched(d['counts'])}")
        rel = r0[f"dp {tag}"]["relation"]
        worst = r0[f"dp {tag}"]["worst"]
        held = (f"worst gradient {worst[0]:.3e} of its parameter's max|grad| ({worst[1]}; tolerance "
                f"{GRAD_ATOL_REL} of it + {GRAD_RTOL} of the element)" if rel is None else
                f"worst gradient {worst:.1f} bf16 ulps of its parameter's max|grad|; against the float32 step, "
                + ", ".join(f"{k} {v[0]:.3e} (one process {v[1]:.3e})" for k, v in rel.items()))
        log(f"  data-parallel step {tag}, b{TRAIN_B} as 2 x {TRAIN_B // MULTI_RANKS}: loss {r0[f'dp {tag}']['loss']!r} "
            f"against one process's {o['loss']!r}; {held}; " + "; ".join(parts)
            + f"; one process {np.median(o['ms']):.3f} ms/step, peak {o['peak_gib']:.3f} GiB")
    # the trainer's rank loop against one process's first epoch
    def losses(exp_dir, key):
        rows = [json.loads(line) for line in (Path(exp_dir) / "metrics.jsonl").read_text().splitlines()]
        return [r["value"] for r in rows if r.get("metric", "").startswith(key)]

    cli_rel = 0.0
    for key in ("train_batch", "val_batch"):
        a, b = losses(r0["cli"]["experiment_dir"], key), losses(one_cli.experiment.dir, key)
        if len(a) != len(b) or not a:
            raise AssertionError(f"trainer rank loop logged {a} against one process's {b}")
        cli_rel = max(cli_rel, max(abs(x - y) / abs(y) for x, y in zip(a, b)))
    if not cli_rel <= RESUME_RTOL or ranks[1]["cli"]["written"] or not r0["cli"]["written"]:
        raise AssertionError(f"trainer rank loop: losses {cli_rel:.3e} from one process's, written "
                             f"{[r['cli']['written'] for r in ranks]}")
    log(f"  trainer rank loop, 1 epoch: {r0['cli']['step']} steps, losses within {cli_rel:.3e} (relative) of one "
        f"process's ({one_s:.2f} s), rank 0 alone wrote {len(r0['cli']['written'])} checkpoints; "
        + "; ".join(f"rank {r['rank']} {r['cli']['seconds']:.2f} s, launches {launched(r['cli']['counts'])}" for r in ranks))
    files = sorted((tmp / "dp_run_one").rglob("*.flo"))
    run_err = max(float(np.abs(read_flow(str(f)) - read_flow(str(tmp / "dp_run_two" / f.relative_to(tmp / "dp_run_one"))))
                        .max()) for f in files)
    if len(files) != DP_CLI_PAIRS or not run_err <= SPATIAL_ATOL or sum(r["run"]["pairs"] for r in ranks) != DP_CLI_PAIRS:
        raise AssertionError(f"run --num_devices 2: {len(files)} files, max diff {run_err}")
    log(f"  run rank function, {DP_CLI_PAIRS} pairs b{RUN_B} a rank a step: files within {run_err:.3e} px of one "
        f"process's; " + "; ".join(f"rank {r['rank']} {r['run']['pairs']} pairs {r['run']['seconds']:.2f} s, "
                                   f"launches {launched(r['run']['counts'])}" for r in ranks))
    for dtype, impl in SPATIAL_VARIANTS:
        key = f"{dtype} {impl}"
        u = unsharded[key]
        log(f"  spatial estimate {key} {SPATIAL_H}x{SPATIAL_W}: unsharded {np.median(u['ms']):.3f} ms, peak "
            f"{u['peak_gib']:.3f} GiB; " + "; ".join(
                f"rank {r['rank']} max abs err {r[f'spatial {key}']['max_abs_err']:.3e} px "
                f"(tolerance {r[f'spatial {key}']['tol']:.3e}), "
                f"{np.median(r[f'spatial {key}']['ms']):.3f} ms, peak {r[f'spatial {key}']['peak_gib']:.3f} GiB "
                f"({r[f'spatial {key}']['peak_gib'] / max(u['peak_gib'], 1e-9):.1%}), {r[f'spatial {key}']['exchanges']} exchanges "
                f"sent {r[f'spatial {key}']['sent'] / 2**20:.3f} MiB, whole-map gathers {r[f'spatial {key}']['gathers']} "
                f"{r[f'spatial {key}']['gather_bytes'] / 2**20:.3f} MiB, launches on slabs {launched(r[f'spatial {key}']['counts'])}"
                for r in ranks))
    log(f"  forced fallback (v = {FALLBACK_V:g} px in rank 1's rows, halo 32): "
        + "; ".join(f"rank {r['rank']} {r['fallback']}" for r in ranks))
    log(f"  phase 9 {time.perf_counter() - t0:.1f} s")
    paths = {PATH_NCCL1: nccl_counts, PATH_DP: r0["dp float32"]["counts"], PATH_DP_BF16: r0["dp bf16"]["counts"],
             PATH_DP_CLI: r0["cli"]["counts"], PATH_DP_RUN: r0["run"]["counts"]}
    for dtype, impl in SPATIAL_VARIANTS:
        paths[f"{PATH_SPATIAL} {dtype} {impl}"] = r0[f"spatial {dtype} {impl}"]["counts"]
    return paths


PARENT_SOURCES = ("backwarp.cu", "backwarp_bwd.cu", "corr49.cu", "corr49_bwd.cu", "corr49_bf16.cu",
                  "corr49_bwd_bf16.cu", "rgb_warp_norm.cu")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    parser.add_argument("--parent", type=Path, default=None,
                        help="another checkout's piv_liteflownet_tpu_torch/csrc: its warp, rgb warp-norm and "
                             "cost-volume kernels are built and timed in turns beside this tree's (phases 4 "
                             "and 5), the rgb warp-norm's outputs held bit-equal to this tree's (phase 2)")
    parser.add_argument("--multi-gpu-only", action="store_true",
                        help="phases 1 and 9 alone, with phase 9's directories (phase 6's dataset, phase "
                             "7's frames) made in their place: a quick check of the multi-GPU paths")
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
                                            tuple(src for src in PARENT_SOURCES if (args.parent / src).is_file()))
        log(f"  the parent's warp and cost-volume kernels from {args.parent}: built in "
            f"{time.perf_counter() - t_parent:.2f} s")
        for src, lines in parent_ptxas.items():
            for line in lines:
                log(f"    parent {src}: {line}")

    ops = (correlation, warp, rgb_warp, conv_chain)
    if args.multi_gpu_only:
        from piv_liteflownet_tpu_torch.data.piv_gen import make_dataset_dir

        with tempfile.TemporaryDirectory() as tmp:
            make_dataset_dir(str(Path(tmp) / "data"), n=DATA_N, size=DATA_SIZE, seed=0, device=dev)
            make_dataset_dir(str(Path(tmp) / "frames"), n=DP_CLI_PAIRS, size=INGEST_SIZE, seed=7, device=dev,
                             write_manifest=False)
            log("phase 9: multi-GPU (one card: NCCL at one rank, two ranks over gloo)")
            run_multi_gpu(dev, ops, card, Path(tmp))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    log("phase 2: kernels against their plain versions")
    errs = check_kernels(dev, ops)
    errs.update(check_bf16_kernels(dev, ops))
    errs.update(check_rgb_kernels(dev, rgb_warp, parent))
    log(f"  ({time.perf_counter() - t_start:.1f} s)")

    log("phase 3: estimate end to end")
    sl = run_slice(dev, ops)
    log("  bf16 inference:")
    sl_bf16 = run_bf16_slice(dev, ops, sl["models"])
    log("  trained weights:")
    trained = run_trained(dev, ops, card)
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
    log(f"  ({time.perf_counter() - t_start:.1f} s)")

    with tempfile.TemporaryDirectory() as tmp:
        log("phase 6: data path and trainer CLI")
        cli = run_data_path(dev, ops, card, tr, tr_bf16, Path(tmp))
        log(f"  ({time.perf_counter() - t_start:.1f} s)")
        log("phase 7: ingest and the inference CLIs")
        t7 = time.perf_counter()
        ingest_paths = run_ingest(dev, ops, card, trained, cli, Path(tmp))
        log(f"  phase 7 {time.perf_counter() - t7:.1f} s ({time.perf_counter() - t_start:.1f} s)")
        log("phase 8: training extras, post-processing and stereo")
        t8 = time.perf_counter()
        extra_paths = run_extras(dev, ops, card, Path(tmp))
        log(f"  phase 8 {time.perf_counter() - t8:.1f} s ({time.perf_counter() - t_start:.1f} s)")
        log("phase 9: multi-GPU (one card: NCCL at one rank, two ranks over gloo)")
        multi_paths = run_multi_gpu(dev, ops, card, Path(tmp))
        log(f"  ({time.perf_counter() - t_start:.1f} s)")

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
    paths[CLI_PATH] = cli["launches"]
    paths[CLI_PATH_BF16] = cli["launches_bf16"]
    paths.update(ingest_paths)
    paths.update(extra_paths)
    paths.update(multi_paths)
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
