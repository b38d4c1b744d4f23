"""Times the rgb warp-norm kernel (``csrc/rgb_warp_norm.cu``) beside variants of its design, in turns,
on one card.

    python tests/rgb_warp_variants.py [--parent DIR]

``tests/rgb_warp_variants.cu`` includes this tree's source and adds the variants (its header says what
each is: fixed pixel counts a lane, a staged window, a staged footprint, 16-byte loads of adjacent
pixels, persistent lanes). It is built with the flags of ``kernels/build.py``
(``chip_smoke.py:warp_library``) under ``build/rgb_warp_variants/``; ``--parent DIR`` (another
checkout's ``piv_liteflownet_tpu_torch/csrc``) builds that tree's ``rgb_warp_norm.cu`` beside it.
The script first holds every variant's output, and the parent's, bit-equal to this tree's kernel on
the timed cases and on odd widths, tensors one and two elements off 16 bytes, flows past the map, NaN
and huge flows, and this tree's kernel to the plain version; then times both forms at
``[1,3,1024,1024]`` and ``[8,3,256,256]``, with ``chip_smoke.smooth_flow`` and a random 8 px flow
(``chip_smoke.py``'s timer: CUDA events, the L2 flushed before each of 100 launches, the median),
every candidate in turn and then in reverse order, three times over, beside the float32
``F.grid_sample`` of the warp half alone, a copy of the same bytes and a one-element launch under the
same timer, and the bound from the bytes; then each candidate warm (``torch.profiler``'s device time
of 20 launches back to back, the L2 holding the inputs, as ``estimate`` finds them) at the six level
shapes of a 1024^2 pair with a smooth flow halved per level. It prints ``ptxas``'s registers, spills
and shared memory for every kernel. Needs a CUDA card; not a test: pytest does not collect it.
"""

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from piv_liteflownet_tpu_torch.kernels import build  # noqa: E402
from piv_liteflownet_tpu_torch.ops import rgb_warp  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
VARIANT_SIG = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
VARIANTS = ("lanes", "lanes1", "window", "window_r4", "vec", "staged", "pipe", "pref1", "pref2", "pref4")


def variant_library():
    out = ROOT / "build" / "rgb_warp_variants"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, out / "csrc")
    shutil.copy(Path(__file__).with_suffix(".cu"), out / "csrc")
    sigs = {f"rgbv_{v}_{d}": VARIANT_SIG for v in VARIANTS for d in ("f32", "bf16")}
    return C.warp_library(out / "csrc", out / "lib", ("rgb_warp_variants.cu",), sigs)


def device_ms(fn, iters=20):
    """Mean device ms of ``fn``'s kernels over ``iters`` calls back to back, from ``torch.profiler``
    (the L2 warm, no host gaps counted)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    return sum(spans) / iters / 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rgb_warp_variants: needs a CUDA card")
    card = C.card_line()
    print(card, flush=True)
    lib, ptxas = variant_library()
    for line in ptxas["rgb_warp_variants.cu"]:
        print(f"  {line}", flush=True)
    parent = None
    if args.parent is not None:
        parent, pptx = C.warp_library(args.parent.resolve(), ROOT / "build" / "rgb_warp_variants" / "parent",
                                      ("rgb_warp_norm.cu",))
        for line in pptx["rgb_warp_norm.cu"]:
            print(f"  parent: {line}", flush=True)
    dev = torch.device("cuda")
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    failures = []

    def candidates(dtype, img1, img2, flow, out):
        sfx = "f32" if dtype == torch.float32 else "bf16"
        ptrs = (img1.data_ptr(), img2.data_ptr(), flow.data_ptr(), out.data_ptr())
        b, _, h, w = img1.shape
        fns = {"tree": C.rgb_call(lib, dev, img1, img2, flow, out)}
        if parent is not None:
            fns["parent"] = C.rgb_call(parent, dev, img1, img2, flow, out)
        for v in VARIANTS:
            fns[v] = (lambda v=v: C.call_entry(lib, f"rgbv_{v}_{sfx}", dev, *ptrs, counter.data_ptr(), b, h, w))
        return fns

    # bit-equality and the plain version
    checks = [(1, 1024, 1024, "smooth", 0), (1, 1024, 1024, 8.0, 0), (8, 256, 256, "smooth", 0),
              (8, 256, 256, 8.0, 0), (2, 37, 53, 30.0, 0), (2, 40, 64, 30.0, 0), (2, 40, 64, 3.0, 1),
              (2, 40, 64, 3.0, 2), (1, 33, 130, "nan", 0), (1, 8, 8, 2.0, 0)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, kind, shift in checks:
            img1, img2, flow = C.rgb_inputs(b, h, w, kind, shift, dtype, 7, dev)
            out = torch.empty((b, 1, h, w), device=dev, dtype=dtype)
            fns = candidates(dtype, img1, img2, flow, out)
            outs = {}
            for name, fn in fns.items():
                out.fill_(float("nan"))
                counter.zero_()
                fn()
                torch.cuda.synchronize()
                outs[name] = (out.clone(), int(counter.item()))
            ref = rgb_warp.rgb_warp_norm_plain(img1.float(), img2.float(), flow.float())
            got = outs["tree"][0]
            tree_err = float((got.float() - ref.to(dtype).float()).abs().max())
            tol = C.WARP_ATOL if dtype == torch.float32 else float(C.bf16_ulp(ref.to(dtype).float()).max()) + C.WARP_ATOL
            what = f"{str(dtype)[6:]} [{b},3,{h},{w}] {C.flow_name(kind)}, {shift} elements off"
            differ = [n for n, (o, _) in outs.items() if not torch.equal(o.view(torch.uint8), got.view(torch.uint8))]
            print(f"  {what}: tree vs plain {tree_err:.3e} (tol {tol:.3e}); gathered directly: window "
                  f"{outs['window'][1]} pixels, window_r4 {outs['window_r4'][1]}, staged {outs['staged'][1]} tiles; "
                  f"differ from the tree: {differ or 'none'}", flush=True)
            if tree_err > tol or differ:
                failures.append(what)
    # times
    for dtype in (torch.float32, torch.bfloat16):
        elt = 4 if dtype == torch.float32 else 2
        for b, h, w in ((1, 1024, 1024), (8, 256, 256)):
            for kind in ("smooth", 8.0):
                img1, img2, flow = C.rgb_inputs(b, h, w, kind, 0, dtype, 3, dev)
                out = torch.empty((b, 1, h, w), device=dev, dtype=dtype)
                timer = C.Timer(dev)
                fns = candidates(dtype, img1, img2, flow, out)
                timed = lambda fn: timer(fn, iters=100)  # noqa: E731
                turns = C.in_turns(timed, fns)
                for _ in range(2):
                    more = C.in_turns(timed, fns)
                    for name in turns:
                        turns[name] += more[name]
                bound = C.bound_ms(elt * 9 * b * h * w, 27 * b * h * w)[0]
                extra = ""
                if dtype == torch.float32:
                    grid = C.pixel_grid(flow, h, w)
                    gs = timer(lambda: F.grid_sample(img2, grid, mode="bilinear", padding_mode="zeros",
                                                     align_corners=True))
                    extra = f", F.grid_sample warp half {gs:.4f}"
                counter.zero_()
                C.call_entry(lib, f"rgbv_window_{'f32' if elt == 4 else 'bf16'}", dev, img1.data_ptr(),
                             img2.data_ptr(), flow.data_ptr(), out.data_ptr(), counter.data_ptr(), b, h, w)
                torch.cuda.synchronize()
                # what the timer gives a copy of the same bytes (read once, written once) and a
                # one-element launch
                src = torch.empty(elt * 9 * b * h * w // 8, device=dev, dtype=torch.float32)
                dst = torch.empty_like(src)
                tiny = torch.empty(1, device=dev)
                extra += (f", a copy of the same bytes {timer(lambda: dst.copy_(src)):.4f}, a one-element "
                          f"launch {timer(lambda: tiny.zero_()):.4f}")
                del src, dst
                print(f"  {str(dtype)[6:]} [{b},3,{h},{w}] {C.flow_name(kind)}: bound {bound:.4f} ms{extra}; "
                      f"window direct pixels {int(counter.item())}  ({card})", flush=True)
                for name, ms in turns.items():
                    med = float(np.median(ms))
                    print(f"    {name:9s} {' / '.join(f'{m:.4f}' for m in ms)} ms ({bound / med:.1%} of the bound)",
                          flush=True)
    # warm, as estimate finds its inputs: each candidate 20 times back to back at each level shape of a
    # 1024^2 pair under torch.profiler (device time of its kernels only), a smooth flow halved per level
    for dtype in (torch.float32, torch.bfloat16):
        sums = {}
        for lv in range(1, 7):
            h = w = 1024 >> (lv - 1)
            img1, img2, flow = C.rgb_inputs(1, h, w, "smooth", 0, dtype, 5, dev)
            flow = (flow.float() * 0.5 ** (lv - 1)).to(dtype)
            out = torch.empty((1, 1, h, w), device=dev, dtype=dtype)
            line = []
            for name, fn in candidates(dtype, img1, img2, flow, out).items():
                ms = device_ms(fn)
                sums[name] = sums.get(name, 0.0) + ms
                line.append(f"{name} {ms:.4f}")
            print(f"  warm {str(dtype)[6:]} level {lv} [1,3,{h},{w}]: " + ", ".join(line) + " ms", flush=True)
        print(f"  warm {str(dtype)[6:]}, the six levels of a 1024^2 pair: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()) + f" ms  ({card})", flush=True)
    if failures:
        print(f"FAILED: {failures}", flush=True)
        return 1
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
