"""Batch inference CLI of the port: ``python -m piv_liteflownet_tpu_torch.run``.

The JAX package's ``run.py`` flags: ``-m/--model``, ``-v/--version``,
``-p/--is_pair``, ``-i/--input`` (directories or ``.pivseq`` files),
``-o/--output``, ``-s/--start``, ``-n/--num_images``, ``-b/--brightness`` and
``-c/--contrast`` (factor lists), ``--params`` (a torch state dict file, or a
``.npz`` of JAX params), ``--batch_size``, ``--bf16`` (the model in bfloat16:
the fast path; the ``.flo`` files stay float32), ``--native_io`` (libpivio's
C loader where its decoders apply), ``--conv_impl {cudnn,chain}`` (the NetE
conv stacks through cuDNN or the ``conv_chain`` kernel) and ``--cpu``. It runs
on the CUDA card unless ``--cpu`` is given. Over several ranks, one process a
device (``parallel/mesh.py:spawn``; the count is clamped to the devices present
and printed), each running :func:`run_rank`: ``--num_devices N`` takes
``batch_size x N`` pairs a step, each rank decoding its own ``batch_size`` of
them and writing their ``.flo`` files; ``--spatial N`` splits each frame's
height over the ranks (``estimate(spatial_mesh=...)``), every rank decoding
the whole batch and rank 0 writing. The two are mutually exclusive. The
brightness/contrast path runs on rank 0 alone, as JAX's runs on one device.
The TPU's implementation selectors ``--warp_impl``,
``--corr_impl`` and ``--conv_bands`` have no counterpart: the port has one
exact gather and one cost-volume kernel.

Directory path (``main_dl``): a ``Run`` dataset (a ``PivseqRun`` for a
``.pivseq`` input) decoded by ``BatchLoader`` threads, or with
``--native_io`` by libpivio's C threads; ``PrefetchLoader`` copies each batch
to the card from pinned memory on a side stream. Two batches stay in flight:
``estimate`` of batch k+1 is launched before the flows of batch k are
written; each batch's flows are copied back into pinned memory without
blocking, behind an event. Brightness/contrast path (``main_mod``, with
``-b``/``-c``): every consecutive frame pair of the directory under every
(brightness, contrast) factor, written as ``<prefix>_<BBB>_<CCC>_<suffix>_out.flo``.

Output layout per input, as in the JAX package:
``<output>/<netname>/<dirbase>[-<start>_<n>]/flow[/left|right]/*_out.flo``
with an ``args.txt`` dump beside ``flow/``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import os
import sys
import time
from collections import deque
from dataclasses import dataclass
from glob import glob
from typing import Optional

import numpy as np
import torch

from piv_liteflownet_tpu_torch.inference import Inference, estimate
from piv_liteflownet_tpu_torch.models.convert import from_jax_params
from piv_liteflownet_tpu_torch.models.factory import config, hui_liteflownet, piv_liteflownet
from piv_liteflownet_tpu_torch.parallel.mesh import Mesh, devices_to_use, spawn
from piv_liteflownet_tpu_torch.utils.flow_io import flowname_modifier, write_flow

NETNAMES = {"hui": "Hui-LiteFlowNet", "piv": "PIV-LiteFlowNet-en"}
MOD_EXTS = ("jpg", "jpeg", "png", "bmp", "tif", "ppm")  # the brightness/contrast path's scan


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="PIV-LiteFlowNet inference on a CUDA card")
    parser.add_argument("--start", "-s", type=int, default=0, help="Input image starting index.")
    parser.add_argument("--num_images", "-n", type=int, default=-1,
                        help="Number of image(s) to process from the directory.")
    parser.add_argument("--is_pair", "-p", action="store_true",
                        help="Inputs are *_img1/*_img2 pairs (else consecutive frames).")
    parser.add_argument("--brightness", "-b", default=None, type=float, nargs="+",
                        help="Brightness factor(s) applied to all input images (optional).")
    parser.add_argument("--contrast", "-c", default=None, type=float, nargs="+",
                        help="Contrast factor(s) applied to all input images (optional).")
    parser.add_argument("--model", "-m", type=str, choices=["hui", "piv"], required=True)
    parser.add_argument("--version", "-v", type=int, choices=[1, 2], default=1,
                        help="LiteFlowNet backbone version (1 or 2).")
    parser.add_argument("--input", "-i", default=["./images/demo"], type=str, nargs="+",
                        help="Input image directory(ies) or packed .pivseq file(s).")
    parser.add_argument("--output", "-o", default="./results", type=str, help="Main output directory.")
    parser.add_argument("--params", type=str, default=None,
                        help="Weights: a torch state dict file, or .npz of JAX params. "
                             "Defaults to models/pretrain_torch/<netname>.paramOnly if present.")
    parser.add_argument("--batch_size", type=int, default=2, help="Image pairs per forward.")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")
    parser.add_argument("--num_devices", "-d", type=int, default=1,
                        help="Ranks (one a card) to split each step's pairs over.")
    parser.add_argument("--bf16", action="store_true",
                        help="Run params and activations in bfloat16 (the fast path); .flo files stay float32.")
    parser.add_argument("--conv_impl", choices=["cudnn", "chain"], default="cudnn",
                        help="The NetE conv stacks through cuDNN, or each through one conv_chain kernel.")
    parser.add_argument("--native_io", action="store_true",
                        help="Decode with libpivio's C threads (PNM/PNG/TIFF pairs, .pivseq); other "
                             "formats take the Python loader. Raises if the library cannot be built.")
    parser.add_argument("--spatial", type=int, default=1,
                        help="Ranks (one a card) to split each frame's height over.")
    return parser


def load_weights(args, cfg):
    """Resolve and load the weights; returns (state dict or None, netname)."""
    path = args.params
    if path is None:
        cand = os.path.join("models", "pretrain_torch", NETNAMES[args.model] + ".paramOnly")
        path = cand if os.path.isfile(cand) else None
    if path is None:
        return None, NETNAMES[args.model]
    netname = os.path.splitext(os.path.basename(path))[0]
    if path.endswith(".npz"):
        with np.load(path) as data:
            return from_jax_params(cfg, dict(data)), netname
    return torch.load(path, map_location="cpu", weights_only=True), netname


def load_image(path: str) -> np.ndarray:
    """An image file as float32 ``[H,W,3]`` in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def image_mod(imgpath: str, brightness_factor: float = 1.0, contrast_factor: float = 1.0):
    """The RGB image with PIL's brightness, then contrast, enhancement."""
    from PIL import Image, ImageEnhance

    img = Image.open(imgpath).convert("RGB")
    img = ImageEnhance.Brightness(img).enhance(brightness_factor)
    return ImageEnhance.Contrast(img).enhance(contrast_factor)


@dataclass
class RunStats:
    """What ``main_dl`` did: pairs written, seconds from the dataset scan to the last file,
    and the loader it took."""

    pairs: int = 0
    seconds: float = 0.0
    loader: str = "python"


def rank_pairs(ds, batch_size: int, mesh: Mesh):
    """The pairs of ``ds`` (a ``Run`` or ``PivseqRun``) that ``mesh``'s rank takes: its
    ``batch_size`` of each step's ``batch_size x N``, in order, as a dataset of the same kind."""
    keep = [i for i in range(len(ds)) if (i // batch_size) % mesh.size == mesh.rank]
    sub = copy.copy(ds)
    sub.pairs = [ds.pairs[i] for i in keep]
    if hasattr(ds, "index_pairs"):
        sub.index_pairs = [ds.index_pairs[i] for i in keep]
    return sub


def main_dl(model, inputdir: str, savedir: str, is_pair: bool = False, start_id: int = 0,
            num_images: int = -1, batch_size: int = 1, native_io: bool = False,
            mesh: Optional[Mesh] = None) -> RunStats:
    """Write one ``.flo`` per frame pair of ``inputdir`` (a directory or a ``.pivseq`` file).

    ``mesh``: a ``data`` mesh (this rank's pairs, :func:`rank_pairs`; ``pairs`` counts them)
    or a ``spatial`` one (every pair through ``estimate(spatial_mesh=...)``, rank 0 writing).
    """
    from piv_liteflownet_tpu_torch.data.datasets import Run
    from piv_liteflownet_tpu_torch.data.loader import BatchLoader, PrefetchLoader, native_loader_for
    from piv_liteflownet_tpu_torch.data.pivseq import PivseqRun

    t0 = time.perf_counter()
    os.makedirs(savedir, exist_ok=True)
    dataset = PivseqRun if inputdir.endswith(".pivseq") else Run
    ds = dataset(inputdir, is_pair=is_pair, n_images=num_images, start_at=start_id)
    print(f"Processing {len(ds)} pairs of images...", flush=True)
    spatial_mesh = mesh if mesh is not None and mesh.axis == "spatial" else None
    if mesh is not None and mesh.axis == "data":
        ds = rank_pairs(ds, batch_size, mesh)
    write = spatial_mesh is None or spatial_mesh.rank == 0
    stats = RunStats(pairs=len(ds))
    loader = None
    if native_io:
        loader = native_loader_for(ds, batch_size)
        if loader is None:
            print("native I/O: not for this dataset's formats; the Python loader's PIL threads", flush=True)
        else:
            stats.loader = "native"
            print(f"native I/O: libpivio's C loader ({type(loader).__name__})", flush=True)
    if loader is None:
        loader = BatchLoader(ds, batch_size=batch_size)
    device = next(model.parameters()).device
    cuda = device.type == "cuda"

    def drain(item) -> None:
        flows, copied, names = item
        if copied is not None:
            copied.synchronize()
        flows = flows.numpy()
        for i, name in enumerate(names if write else ()):
            write_flow(flows[i], flowname_modifier(name, savedir, pair=False))

    inflight: deque = deque()  # two batches in flight: launches overlap the drain and the writes
    try:
        for (im1, im2), names in PrefetchLoader(loader, device, fence=getattr(loader, "fence", None)):
            flows = estimate(model, im1, im2, tensor=True, spatial_mesh=spatial_mesh).float()
            if cuda:
                host = torch.empty(flows.shape, dtype=torch.float32, pin_memory=True)
                host.copy_(flows, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record()
                inflight.append((host, copied, names))
            else:
                inflight.append((flows, None, names))
            if len(inflight) > 2:
                drain(inflight.popleft())
        while inflight:
            drain(inflight.popleft())
    finally:
        if hasattr(loader, "close"):
            loader.close()
    stats.seconds = time.perf_counter() - t0
    print(f"Finish processing all images from {inputdir} path!", flush=True)
    return stats


def mod_images(inputdir: str, start_id: int = 0, num_images: int = -1) -> list:
    """The frames of the brightness/contrast path: each extension of ``MOD_EXTS`` in turn,
    sorted, then sliced."""
    names = []
    for ext in MOD_EXTS:
        names += sorted(glob(os.path.join(inputdir, f"*.{ext}")))
    return names[start_id:] if num_images < 0 else names[start_id:start_id + num_images]


def main_mod(model, inputdir: str, savedir: str, start_id: int = 0, num_images: int = -1,
             mod_factors=((1, 1),)) -> list:
    """The flow of every consecutive frame pair under each (brightness, contrast) factor;
    ``<prefix>_img1.png`` under (0.8, 1.2) gives ``<prefix>_080_120_img1.png`` and so
    ``<prefix>_080_120_img1_out.flo``. Returns the files written."""
    os.makedirs(savedir, exist_ok=True)
    written = []
    prev = None
    for curr in mod_images(inputdir, start_id, num_images):
        if prev is not None:
            for brightness, contrast in mod_factors:
                flow = Inference.parser(model, image_mod(prev, brightness, contrast),
                                        image_mod(curr, brightness, contrast))
                modname = f"{str(int(brightness * 100)).zfill(3)}_{str(int(contrast * 100)).zfill(3)}"
                imgname, imgext = prev.rsplit("_", 1)
                out_name = flowname_modifier(imgname + "_" + modname + "_" + imgext, savedir, pair=False)
                write_flow(flow, out_name)
                written.append(out_name)
        prev = curr
    print(f"Finish processing all images from {inputdir} path!", flush=True)
    return written


def output_dirs(args, imdir: str) -> tuple[str, str, str]:
    """(savedir, flodir, args file name) of one input directory."""
    is_all = args.start == 0 and args.num_images < 0
    checkname = os.path.basename(os.path.normpath(imdir))
    if checkname.lower() in ("left", "right"):  # stereoscopic layout
        extradir = checkname.lower()
        bname = os.path.basename(os.path.dirname(os.path.normpath(imdir)))
    else:
        extradir = None
        bname = checkname
    num = "end" if args.num_images < 0 else args.num_images
    savedir = os.path.join(args.output, args.netname, bname if is_all else f"{bname}-{args.start}_{num}")
    if extradir is None:
        return savedir, os.path.join(savedir, "flow"), "args.txt"
    return savedir, os.path.join(savedir, "flow", extradir), f"args_{extradir}.txt"


def main(argv=None) -> list:
    """Parse ``argv`` and run every input; returns each input's ``RunStats`` (directory path)
    or list of files written (brightness/contrast path); over several ranks, rank 0's."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.num_devices > 1 and args.spatial > 1:
        raise ValueError("--spatial and --num_devices are mutually exclusive")
    if max(args.num_devices, args.spatial) > 1:
        axis = "spatial" if args.spatial > 1 else "data"
        n = devices_to_use(max(args.num_devices, args.spatial), args.cpu,
                           "spatial inference" if axis == "spatial" else "data-parallel inference")
        if n > 1:
            return spawn(run_rank, n, argv, axes=(axis,), devices=["cpu"] * n if args.cpu else None)[0]
    return run(args)


def run_rank(mesh: Mesh, argv) -> list:
    """One rank of ``run`` over ``mesh`` (``data``: ``--num_devices``, or ``spatial``: ``--spatial``);
    ranks other than 0 print nothing. Returns what :func:`run` returns on this rank."""
    args = build_parser().parse_args(list(argv))
    with contextlib.nullcontext() if mesh.rank == 0 else contextlib.redirect_stdout(io.StringIO()):
        return run(args, mesh)


def run(args, mesh: Optional[Mesh] = None) -> list:
    """Run every input of the parsed ``args``, in this process or as ``mesh``'s rank."""
    cfg = config(args.model, args.version)
    factory = hui_liteflownet if args.model == "hui" else piv_liteflownet
    device = mesh.device if mesh is not None else ("cpu" if args.cpu else None)
    rank0 = mesh is None or mesh.rank == 0
    weights, args.netname = load_weights(args, cfg)
    if weights is None:
        print("WARNING: no weight file found or given; using a seeded random init", flush=True)
    model = factory(weights, version=args.version, device=device, conv_impl=args.conv_impl)
    if args.bf16:
        model = model.to(torch.bfloat16)
        print("bfloat16 fast path enabled", flush=True)
    print(f"Running on {next(model.parameters()).device}, conv_impl={args.conv_impl}", flush=True)
    results = []
    for imdir in args.input:
        savedir, flodir, argsname = output_dirs(args, imdir)
        os.makedirs(savedir, exist_ok=True)
        if rank0:
            with open(os.path.join(savedir, argsname), "w") as f:
                for argument, value in sorted(vars(args).items()):
                    f.write(f"{argument}: {value}\n")
        if args.brightness is None and args.contrast is None:
            results.append(main_dl(model, imdir, flodir, is_pair=args.is_pair, start_id=args.start,
                                   num_images=args.num_images, batch_size=args.batch_size,
                                   native_io=args.native_io, mesh=mesh))
        elif not rank0:
            results.append([])
        else:
            brightness = (1.0,) if args.brightness is None else tuple(args.brightness)
            contrast = (1.0,) if args.contrast is None else tuple(args.contrast)
            results.append(main_mod(model, imdir, flodir, start_id=args.start, num_images=args.num_images,
                                    mod_factors=tuple((b, c) for b in brightness for c in contrast)))
    return results


if __name__ == "__main__":
    main()
