"""Times the conv chain kernel built from variants of its source, in turns, on one card.

    python tests/conv_chain_variants.py            # the bf16 form against the variants below
    python tests/conv_chain_variants.py --f32 DIR  # the f32 form against the sources in DIR

Each variant is ``csrc/`` with some lines replaced (or, for ``--f32``, DIR: another checkout's
``piv_liteflownet_tpu_torch/csrc``), built by ``kernels/build.py`` into its own directory under
``build/chain_variants/``. The script times ``conv_chain`` at the piv v1 level-1 M, S and R
stacks of a 1024^2 pair and the v2 level-2 M and S stacks (``chip_smoke.py``'s stacks and
timer: CUDA events, the L2 flushed before each of 10 launches, the median), running the
variants in turn and then in reverse order, and prints each variant's ``ptxas`` registers and
spills, its two times per stack, and whether its output equals the first variant's. Needs a
CUDA card; not a test: pytest does not collect it.
"""

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from piv_liteflownet_tpu_torch.kernels import build  # noqa: E402
from piv_liteflownet_tpu_torch.ops import conv_chain as cc  # noqa: E402

MIN_BLOCKS = "constexpr int MIN_BLOCKS = is_f32<T> ? 1 : 2;"
K7_BN64 = "        else mma_layer_bf16<7, 64>(src, cin, w, bias, cout, dst, B, H, W, act, sm);"
# name -> (line replacements in conv_chain.cu, channel tiles of the bf16 plan)
VARIANTS = {
    "this tree": ([], cc.MMA_WIDTHS),
    "one block per SM": ([(MIN_BLOCKS, "constexpr int MIN_BLOCKS = 1;")], cc.MMA_WIDTHS),
    "three blocks per SM": ([(MIN_BLOCKS, "constexpr int MIN_BLOCKS = is_f32<T> ? 1 : 3;")], cc.MMA_WIDTHS),
    "no 7x7 BN 64": ([(K7_BN64, K7_BN64.replace("<7, 64>", "<5, 64>"))], cc.MMA_WIDTHS),
    "BN 32 only": ([], (32,)),
}


def build_variant(name: str, csrc: Path, edits) -> object:
    out = ROOT / "build" / "chain_variants" / name.replace(" ", "_")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out / "csrc")
    for old, new in edits:
        f = out / "csrc" / "conv_chain.cu"
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the line to replace is not in conv_chain.cu once: {old!r}")
        f.write_text(text.replace(old, new))
    build.CSRC_DIR, build.BUILD_DIR, build._lib = out / "csrc", out / "build", None
    log, keep = build.build(force=True).log, False
    for line in log.splitlines():
        if line.startswith("=="):
            keep = line == "== conv_chain.cu"
        elif keep and any(k in line for k in ("registers", "spill")):
            print(f"  {name}: {line.strip()}", flush=True)
    # build.load(), for a library that may lack the entry points of later sources
    lib = ctypes.CDLL(str(build.build().path))
    for fn_name, argtypes in build.SIGNATURES.items():
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.pivk_error_string.argtypes, lib.pivk_error_string.restype = (ctypes.c_int,), ctypes.c_char_p
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--f32", metavar="DIR", type=Path,
                        help="time the f32 form of this tree against the sources in DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_chain_variants: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    print(C.card_line(), flush=True)
    csrc = build.CSRC_DIR
    if args.f32:
        variants = {"this tree": ([], cc.MMA_WIDTHS), "other": ([], cc.MMA_WIDTHS)}
        sources = {"this tree": csrc, "other": args.f32}
        dtype = torch.float32
    else:
        variants, sources, dtype = VARIANTS, dict.fromkeys(VARIANTS, csrc), torch.bfloat16
    libs, built = {}, {}
    for name, (edits, _) in variants.items():
        key = (str(sources[name]), tuple(edits))
        if key not in built:  # "BN 32 only" runs the library of this tree
            built[key] = build_variant(name, sources[name], edits)
        libs[name] = built[key]
    dev = torch.device("cuda")
    timer = C.Timer(dev)
    stacks = []
    for i, (name, parts_c, stack, last_k, last_linear, b, h, w) in enumerate(C.chain_cases()[:5]):
        tensors = C.chain_stack(parts_c, stack, last_k, b, h, w, 40 + i, dev)
        stacks.append((name, [[t.to(dtype) for t in ts] for ts in tensors], last_linear))

    def use(name):
        build._lib = libs[name]
        cc.MMA_WIDTHS = variants[name][1]
        cc._packs.clear()

    times = {}
    with torch.no_grad():
        for name in list(variants) + list(reversed(variants)):
            use(name)
            for stack_name, operands, last_linear in stacks:
                ms = timer(lambda: cc.conv_chain(*operands, last_linear), iters=10)
                times.setdefault((name, stack_name), []).append(ms)
        for stack_name, operands, last_linear in stacks:
            first = None
            for name in variants:
                use(name)
                out = cc.conv_chain(*operands, last_linear)
                torch.cuda.synchronize()
                first = out if first is None else first
                ms = ", ".join(f"{t:.4f}" for t in times[name, stack_name])
                print(f"{str(dtype)[6:]} {stack_name:13s} {name:20s} {ms} ms, output equal to the first "
                      f"variant's: {bool(torch.equal(out, first))}", flush=True)
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
