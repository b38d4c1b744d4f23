"""Times the conv chain kernel built from variants of its source, in turns, on one card.

    python tests/conv_chain_variants.py             # the bf16 form against the variants below
    python tests/conv_chain_variants.py --f32 DIR   # the f32 form against the sources in DIR
    python tests/conv_chain_variants.py --bf16 DIR  # the bf16 form against the sources in DIR

Each variant is ``csrc/`` with some lines of ``conv_chain.cu`` replaced (or, for ``--f32`` and
``--bf16``, DIR: another checkout's ``piv_liteflownet_tpu_torch/csrc``), built with the flags of
``kernels/build.py`` into its own directory under ``build/chain_variants/``, all at once (the
other sources once per tree). With ``--bf16`` the other tree's weights are packed by its own
``ops/conv_chain.py`` (DIR/../ops/conv_chain.py, loaded beside this tree's), since the packed
layout belongs to the kernel. The default variants take parts of the bf16 tensor-core layers
away (the products, the epilogue's stores, the input loads, the repacking) to show where the time
goes; their outputs are wrong on purpose. The script times ``conv_chain`` at the piv v1 level-1
M, S and R stacks of a 1024^2 pair, the v2 level-2 M and S stacks and the v1 level-1 S stack's
first two layers alone (``chip_smoke.py``'s stacks and timer: CUDA events, the L2 flushed before
each of 10 launches, the median), running the variants in turn and then in reverse order, and
prints each variant's ``ptxas`` registers and spills, its two times per case, and whether its
output equals the first variant's (with ``--bf16`` the largest difference, the two trees summing
in other orders); with ``--bf16`` also each tree's per-layer split of the level-1 stacks
(``chip_smoke.py:chain_layer_split``), in turns. Needs a CUDA card; not a test: pytest does not
collect it.
"""

import argparse
import ctypes
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from piv_liteflownet_tpu_torch.kernels import build  # noqa: E402
from piv_liteflownet_tpu_torch.ops import conv_chain as cc  # noqa: E402

WGMMA = "            wgmma_bf16<BN>(acc[m], at(a_desc, a_base + ((m + ky) * TC_SW + kx) * 16), bd);"
STORES = "      if (y < H) {"
LOADS = [("      tma_load_4d(dst, map, ch * CK, x0, y0, b, full);", ""),
         ("      tma_load_4d(dst + plane, map, ch * CK + 8, x0, y0, b, full);", ""),
         ("      mbar_expect_tx(full, 2 * box);", "      mbar_expect_tx(full, 0);")]
NO_PRODUCTS = [(WGMMA, "            ;"), (STORES, "      if (false) {")]
TC_NB = "constexpr int TC_NB = 6;"
# name -> (line replacements in conv_chain.cu, channel tiles of the bf16 plan)
VARIANTS = {
    "this tree": ([], cc.MMA_WIDTHS_BF16),
    "no epilogue stores": ([(STORES, "      if (false) {")], cc.MMA_WIDTHS_BF16),
    "no wgmma": ([(WGMMA, "            ;")], cc.MMA_WIDTHS_BF16),
    "no wgmma, no stores": (NO_PRODUCTS, cc.MMA_WIDTHS_BF16),
    "- and no input loads": (NO_PRODUCTS + LOADS, cc.MMA_WIDTHS_BF16),
    "- and no repacking": (NO_PRODUCTS + LOADS + [("  repack_parts(c, c.buf[1]);", "")],
                           cc.MMA_WIDTHS_BF16),
    "weight ring of 8": ([(TC_NB, TC_NB.replace("6", "8"))], cc.MMA_WIDTHS_BF16),
    "BN 64 at most": ([], (64, 32)),
}


def other_packer(csrc: Path):
    """The other tree's ``ops/conv_chain.py`` as a module of its own (it imports this tree's
    ``kernels``, whose library ``use`` swaps)."""
    spec = importlib.util.spec_from_file_location("other_conv_chain", csrc.parent / "ops" / "conv_chain.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up while it loads
    spec.loader.exec_module(mod)
    return mod


def load_library(path: Path) -> ctypes.CDLL:
    """``build.load()`` for a library at ``path`` that may lack the entry points of later sources."""
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in build.SIGNATURES.items():
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.pivk_error_string.argtypes, lib.pivk_error_string.restype = (ctypes.c_int,), ctypes.c_char_p
    return lib


def build_all(specs) -> dict:
    """A library per variant, ``name -> (csrc dir, line replacements)``, every ``nvcc`` started at
    once: each variant's ``conv_chain.cu``, and the other sources once per csrc dir. Returns
    ``name -> library``, and prints each variant's ``ptxas`` registers and spills."""
    nvcc, root = build.find_nvcc(), ROOT / "build" / "chain_variants"
    shutil.rmtree(root, ignore_errors=True)
    procs, objects, shared = [], {}, {}

    def compile_(key, src, obj, include):
        obj.parent.mkdir(parents=True, exist_ok=True)
        procs.append((key, src.name, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(include), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    for name, (csrc, edits) in specs.items():
        out = root / name.replace(" ", "_").replace(",", "").replace("-", "")
        shutil.copytree(csrc, out / "csrc")
        f = out / "csrc" / "conv_chain.cu"
        text = f.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the line to replace is not in conv_chain.cu once: {old!r}")
            text = text.replace(old, new)
        f.write_text(text)
        if csrc not in shared:  # the sources other than conv_chain.cu, once per tree
            shared[csrc] = []
            for src in sorted(p for p in (out / "csrc").glob("*.cu") if p.name != "conv_chain.cu"):
                shared[csrc].append(out / "obj" / (src.stem + ".o"))
                compile_(name, src, shared[csrc][-1], out / "csrc")
        objects[name] = [out / "obj" / "conv_chain.o", *shared[csrc]]
        compile_(name, f, objects[name][0], out / "csrc")
    for name, source, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed on {source}:\n{log}")
        if source == "conv_chain.cu":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)
    libs = {}
    for name, objs in objects.items():
        lib = objs[0].parent / build.LIB_NAME
        subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(lib)], check=True,
                       capture_output=True)
        libs[name] = load_library(lib)
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    form = parser.add_mutually_exclusive_group()
    form.add_argument("--f32", metavar="DIR", type=Path,
                      help="time the f32 form of this tree against the sources in DIR")
    form.add_argument("--bf16", metavar="DIR", type=Path,
                      help="time the bf16 form of this tree against the sources in DIR (and its packer)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_chain_variants: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    print(C.card_line(), flush=True)
    csrc = build.CSRC_DIR
    modules = {}
    if args.f32 or args.bf16:
        other = args.f32 or args.bf16
        variants = {"this tree": ([], None), "other": ([], None)}
        sources = {"this tree": csrc, "other": other}
        dtype = torch.float32 if args.f32 else torch.bfloat16
        if args.bf16:
            modules["other"] = other_packer(other)
    else:
        variants, sources, dtype = VARIANTS, dict.fromkeys(VARIANTS, csrc), torch.bfloat16
    libs = build_all({name: (sources[name], edits) for name, (edits, _) in variants.items()})
    dev = torch.device("cuda")
    timer = C.Timer(dev)
    stacks = []
    for i, (name, parts_c, stack, last_k, last_linear, b, h, w) in enumerate(C.chain_cases()[:5]):
        tensors = [[t.to(dtype) for t in ts]
                   for ts in C.chain_stack(parts_c, stack, last_k, b, h, w, 40 + i, dev)]
        stacks.append((name, tensors, last_linear))
        if name == "v1 S level 1":  # its first two layers alone, each on its own input
            for j in (0, 1):
                cin = tensors[1][j].shape[1]
                parts = tensors[0] if j == 0 else [C.randn((b, cin, h, w), 50 + j, dev).to(dtype)]
                stacks.append((f"S layer {j} alone", [parts, [tensors[1][j]], [tensors[2][j]]], False))
    widths = cc.MMA_WIDTHS_BF16

    def use(name):
        """Route ``conv_chain`` through variant ``name``: its library, its packer, its tiles."""
        build._lib = libs[name]
        mod = modules.get(name, cc)
        mod._packs.clear()
        cc.MMA_WIDTHS_BF16 = variants[name][1] or widths
        return mod

    times = {}
    with torch.no_grad():
        for name in list(variants) + list(reversed(variants)):
            mod = use(name)
            for stack_name, operands, last_linear in stacks:
                ms = timer(lambda: mod.conv_chain(*operands, last_linear), iters=10)
                times.setdefault((name, stack_name), []).append(ms)
        for stack_name, operands, last_linear in stacks:
            first = None
            for name in variants:
                out = use(name).conv_chain(*operands, last_linear)
                torch.cuda.synchronize()
                first = out if first is None else first
                ms = ", ".join(f"{t:.4f}" for t in times[name, stack_name])
                if args.bf16:
                    diff = float((out.float() - first.float()).abs().max())
                    same = f"max |difference| from the first tree's {diff:.3e}"
                else:
                    same = f"output equal to the first variant's: {bool(torch.equal(out, first))}"
                print(f"{str(dtype)[6:]} {stack_name:13s} {name:20s} {ms} ms, {same}", flush=True)
        if args.bf16:
            for name in list(variants) + list(reversed(variants)):
                C.chain_layer_split(dev, use(name), timer, C.card_line(), f" [{name}]")
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
