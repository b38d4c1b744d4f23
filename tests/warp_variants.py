"""Times the bf16 warp kernels built from variants of their sources, in turns, on one card.

    python tests/warp_variants.py

Each variant is ``csrc/`` with some lines of ``backwarp.cu`` or ``backwarp_bwd.cu`` replaced,
built with the flags of ``kernels/build.py`` (``chip_smoke.py:warp_library``) into its own
directory under ``build/warp_variants/``, all at once. The variants change one choice of the
bf16 forms' designs: the channels a stage of the backward (``CH``) and its launch bounds, the
channels a stage of the forward (``G``), its footprint cap (``CHUNKS``) and its staging as a
whole (every tile gathering directly, in the staged kernel's 32x8 tiles). The script times
``pivk_backwarp_bf16`` at ``[1,64,1024,1024]`` and ``pivk_backwarp_bwd_bf16`` at
``[8,64,256,256]`` (``chip_smoke.py``'s shapes and timer: CUDA events, the L2 flushed before each
of 30 launches, the median), each at stride 1 with a smooth and a random 8 px flow and at stride 2
with a smooth one, the variants in turn and then in reverse order, and prints each variant's
``ptxas`` registers and spills, its two times per case, and whether its outputs equal this tree's
bit for bit. Needs a CUDA card; not a test: pytest does not collect it.
"""

import concurrent.futures
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from piv_liteflownet_tpu_torch.kernels import build  # noqa: E402
from piv_liteflownet_tpu_torch.ops import warp  # noqa: E402

CH = "constexpr int CH = 4;"
LB = "__global__ void __launch_bounds__(NT, 4)\nbackwarp_bwd_owner_kernel"
G = "constexpr int G = 4;            // channels a stage"
CHUNKS = "constexpr int CHUNKS = 256;"
DIRECT = "  if (!aligned || n > CHUNKS) {"
# name -> [(source, line, replacement)]
VARIANTS = {
    "this tree": [],
    "bwd CH 2": [("backwarp_bwd.cu", CH, CH.replace("4", "2"))],
    "bwd CH 1": [("backwarp_bwd.cu", CH, CH.replace("4", "1"))],
    "bwd 5 blocks an SM": [("backwarp_bwd.cu", LB, LB.replace("(NT, 4)", "(NT, 5)"))],
    "fwd G 2": [("backwarp.cu", G, G.replace("4", "2"))],
    "fwd CHUNKS 128": [("backwarp.cu", CHUNKS, CHUNKS.replace("256", "128"))],
    "fwd no staging": [("backwarp.cu", DIRECT, "  if (true) {")],
}


def build_variant(item):
    name, edits = item
    out = ROOT / "build" / "warp_variants" / name.replace(" ", "_")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, out / "csrc")
    for source, old, new in edits:
        f = out / "csrc" / source
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the line to replace is not in {source} once: {old!r}")
        f.write_text(text.replace(old, new))
    return name, C.warp_library(out / "csrc", out / "lib")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("warp_variants: needs a CUDA card")
    print(C.card_line(), flush=True)
    libs = {}
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        for name, (lib, ptxas) in pool.map(build_variant, VARIANTS.items()):
            libs[name] = lib
            for source, lines in ptxas.items():
                kept = [line for line in lines if "registers" in line or "spill" in line]
                print(f"  {name} {source}: " + " | ".join(kept), flush=True)
    dev = torch.device("cuda")
    bf = torch.bfloat16
    timer = C.Timer(dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    cases = []
    for b, c, h, w, backward in ((1, 64, C.MAIN_H, C.MAIN_W, False), (C.TRAIN_B, 64, C.TRAIN_H, C.TRAIN_W, True)):
        img = C.randn((b, c, h, w), 3, dev).to(bf)
        for s, kind in ((1, "smooth"), (1, 8.0), (2, "smooth")):
            ho, wo = warp.out_hw(h, w, s)
            flow = C.make_flow(kind, b, ho, wo, s, h, w, 4, dev).to(bf)
            if backward:
                gout = C.randn((b, c, ho, wo), 5, dev).to(bf)
                outs = {name: (torch.empty_like(img), torch.empty_like(flow)) for name in VARIANTS}
                boxes = torch.empty((b, *warp.owner_grid(h, w), 4), device=dev, dtype=torch.int32)

                def call(name, img=img, flow=flow, gout=gout, outs=outs, boxes=boxes, s=s, shape=(b, c, h, w, ho, wo)):
                    g_img, g_flow = outs[name]
                    return lambda: C.call_entry(libs[name], "pivk_backwarp_bwd_bf16", dev, img.data_ptr(),
                                                flow.data_ptr(), gout.data_ptr(), g_img.data_ptr(),
                                                g_flow.data_ptr(), counter.data_ptr(), boxes.data_ptr(),
                                                *shape, s)
            else:
                outs = {name: (torch.empty((b, c, ho, wo), device=dev, dtype=bf),) for name in VARIANTS}

                def call(name, img=img, flow=flow, outs=outs, s=s, shape=(b, c, h, w, ho, wo)):
                    return lambda: C.call_entry(libs[name], "pivk_backwarp_bf16", dev, img.data_ptr(),
                                                flow.data_ptr(), outs[name][0].data_ptr(), counter.data_ptr(),
                                                *shape, s)
            what = f"{'backwarp_bwd' if backward else 'backwarp'} [{b},{c},{h},{w}] stride {s} {C.flow_name(kind)}"
            cases.append((what, {name: call(name) for name in VARIANTS}, outs))
    for what, fns, outs in cases:
        times = C.in_turns(timer, fns)
        for name in VARIANTS:
            fns[name]()
        torch.cuda.synchronize()
        for name, (t1, t2) in times.items():
            same = all(torch.equal(a.view(torch.int16), r.view(torch.int16))
                       for a, r in zip(outs[name], outs["this tree"]))
            print(f"{what}: {name:20s} {t1:.4f} / {t2:.4f} ms, outputs equal to this tree's: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
