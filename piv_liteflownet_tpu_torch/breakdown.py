"""Where the device time of ``estimate`` or of a train step goes, from a ``torch.profiler`` trace.

    python -m piv_liteflownet_tpu_torch.breakdown [--size 1024] [--batch 1] [--iters 5] [--train]
        [--version 1] [--conv_impl cudnn] [--bf16]

Runs PIV-LiteFlowNet-en (``--version`` 1) or PIV-LiteFlowNet2-en (2), seeded
random weights, on a synthetic particle pair with the inputs on the card,
traces ``--iters`` calls of ``estimate`` (or, with ``--train``, of the Adam
train step with the piv loss; for version 2 the six-weight ``MultiScale``)
after a warm-up (``--bf16``: ``estimate`` of the model cast to bfloat16, or
with ``--train`` the mixed-precision step ``compute_dtype=torch.bfloat16``;
the kernels' bf16 forms), and prints per call: the device time of each group of CUDA kernels
(convs, the port's kernels, the optimizer, elementwise, resize, memory
copies, other), the part of the convs' time that cuDNN spends transposing
NCHW tensors to NHWC and back (bf16), the device busy time, the span from the first kernel's
start to the last kernel's end, and the device idle share within that span,
followed by the top kernels by device time. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from collections import defaultdict
from typing import Iterable, List, Tuple

import torch

GROUPS = (
    ("conv_chain", ("conv_chain_f32_kernel", "conv_chain_bf16_kernel")),
    ("corr49", ("corr49_kernel", "corr49_bf16_kernel")),  # the float32 form, the bf16 form
    ("backwarp", ("backwarp_kernel", "backwarp_staged_kernel")),  # the float32 form, the bf16 form
    ("rgb_warp_norm", ("rgb_warp_norm_lanes_kernel",)),  # both forms, one or two pixels a lane
    ("corr49_bwd", ("corr49_bwd_kernel", "corr49_bwd_bf16_kernel")),
    # the float32 form; the bf16 form's main kernel and its pre-pass over the flow
    ("backwarp_bwd", ("backwarp_bwd_kernel", "backwarp_bwd_owner_kernel", "owner_boxes_kernel")),
    ("conv", ("conv", "gemm", "xmma", "cutlass", "cudnn", "implicit", "winograd", "fft", "sm90_",
              "wgrad", "dgrad")),
    ("optimizer", ("multi_tensor", "adam")),
    ("resize", ("upsample",)),
    ("memcpy/memset", ("memcpy", "memset")),
    ("elementwise/reduce", ("elementwise", "reduce", "vectorized", "cat", "index", "gather", "copy")),
)


#: Kernel names of cuDNN's layout transposes, counted in the conv group and also apart.
TRANSPOSES = ("nchwtonhwc", "nhwctonchw")


def group_of(kernel_name: str) -> str:
    low = kernel_name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def busy_and_span(intervals: Iterable[Tuple[float, float]]) -> Tuple[float, float]:
    """(union length, first start to last end) of ``(start, end)`` intervals."""
    ivs = sorted(intervals)
    if not ivs:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, ivs[0][0], ivs[0][1]
    for s, e in ivs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in ivs) - ivs[0][0]


def summarize(kernels: List[Tuple[str, float, float]], calls: int) -> dict:
    """Per-call device ms by group, busy ms, span ms and idle share from ``(name, start_us, end_us)``."""
    by_group: dict = defaultdict(float)
    by_name: dict = defaultdict(lambda: [0.0, 0])
    transposes = 0.0
    for name, s, e in kernels:
        by_group[group_of(name)] += (e - s) / 1e3 / calls
        transposes += (e - s) / 1e3 / calls if any(k in name.lower() for k in TRANSPOSES) else 0.0
        by_name[name][0] += (e - s) / 1e3 / calls
        by_name[name][1] += 1
    busy, span = busy_and_span((s, e) for _, s, e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "device_ms_per_call": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "conv_layout_transposes_ms_per_call": transposes,
        "busy_ms_per_call": busy / 1e3 / calls,
        "span_ms_per_call": span / 1e3 / calls,
        "idle_share": 1.0 - busy / span if span > 0 else None,
        "top_kernels": [(n[:90], ms, cnt // calls) for n, (ms, cnt) in top],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--train", action="store_true", help="trace train steps, not estimate")
    parser.add_argument("--version", type=int, choices=[1, 2], default=1)
    parser.add_argument("--conv_impl", choices=["cudnn", "chain"], default="cudnn",
                        help="the NetE conv stacks of estimate: cuDNN, or the conv_chain kernel")
    parser.add_argument("--bf16", action="store_true",
                        help="estimate of the model in bfloat16, or with --train the bf16 train step")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: needs a CUDA card")

    from piv_liteflownet_tpu_torch import piv_liteflownet
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.utils.synthetic import particle_pair

    model = piv_liteflownet(version=args.version, seed=0, conv_impl=args.conv_impl)
    if args.bf16 and not args.train:
        model = model.to(torch.bfloat16)
    shift = (2.5, -1.5)
    im1, im2 = particle_pair(args.batch, args.size, args.size, seed=0, shift=shift)
    t1, t2 = torch.from_numpy(im1).cuda(), torch.from_numpy(im2).cuda()
    if args.train:
        from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_train_step
        from piv_liteflownet_tpu_torch.training.loss import piv_loss, v2_multiscale
        from piv_liteflownet_tpu_torch.training.optim import make_optimizer

        opt = make_optimizer(model, model.cfg.lowest_level)
        step = make_train_step(model.cfg, piv_loss() if args.version == 1 else v2_multiscale(), opt,
                               compute_dtype=torch.bfloat16 if args.bf16 else None)
        state = TrainState(model, opt)
        target = torch.empty((args.batch, args.size, args.size, 2), device="cuda")
        target[...] = torch.tensor(shift, device="cuda")

        def call():
            step(state, t1, t2, target)
    else:
        def call():
            estimate(model, t1, t2, tensor=True)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.iters):
            call()
        torch.cuda.synchronize()
    # device events only: kernels, copies and memsets, not the ranges that the profiler's own
    # annotations (Optimizer.step#Adam.step) span on the device timeline
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    if not kernels:
        print(f"breakdown {args.size}x{args.size} b{args.batch}: the profiler saw no CUDA "
              f"events; device time not measured ({card})", flush=True)
        return 1
    out = summarize(kernels, args.iters)
    out.update(what="train step" if args.train else "estimate", version=args.version,
               conv_impl=args.conv_impl, dtype="bfloat16" if args.bf16 else "float32", size=args.size, batch=args.batch, calls=args.iters, card=card)
    print(json.dumps(out, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
