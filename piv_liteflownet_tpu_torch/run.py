"""Batch inference CLI of the port: ``python -m piv_liteflownet_tpu_torch.run``.

The slice's subset of the JAX package's ``run.py`` flags: ``-m/--model``,
``-v/--version``, ``-p/--is_pair``, ``-i/--input`` (several), ``-o/--output``,
``-s/--start``, ``-n/--num_images``, ``--batch_size``, ``--params`` (a torch
state dict file, or a ``.npz`` of JAX params), ``--bf16`` (the model in
bfloat16: the fast path; the ``.flo`` files stay float32) and ``--cpu``.

Output layout per input directory, as in the JAX package:
``<output>/<netname>/<dirbase>[-<start>_<n>]/flow[/left|right]/*_out.flo``
with an ``args.txt`` dump beside ``flow/``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from piv_liteflownet_tpu_torch.inference import estimate
from piv_liteflownet_tpu_torch.models.convert import from_jax_params
from piv_liteflownet_tpu_torch.models.factory import config, hui_liteflownet, piv_liteflownet
from piv_liteflownet_tpu_torch.utils.flow_io import flowname_modifier, image_pairs, write_flow

NETNAMES = {"hui": "Hui-LiteFlowNet", "piv": "PIV-LiteFlowNet-en"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="PIV-LiteFlowNet inference on a CUDA card")
    parser.add_argument("--start", "-s", type=int, default=0, help="Input image starting index.")
    parser.add_argument("--num_images", "-n", type=int, default=-1,
                        help="Number of image(s) to process from the directory.")
    parser.add_argument("--is_pair", "-p", action="store_true",
                        help="Inputs are *_img1/*_img2 pairs (else consecutive frames).")
    parser.add_argument("--model", "-m", type=str, choices=["hui", "piv"], required=True)
    parser.add_argument("--version", "-v", type=int, choices=[1, 2], default=1,
                        help="LiteFlowNet backbone version (1 or 2).")
    parser.add_argument("--input", "-i", default=["./images/demo"], type=str, nargs="+",
                        help="Input image directory(ies).")
    parser.add_argument("--output", "-o", default="./results", type=str, help="Main output directory.")
    parser.add_argument("--params", type=str, default=None,
                        help="Weights: a torch state dict file, or .npz of JAX params. "
                             "Defaults to models/pretrain_torch/<netname>.paramOnly if present.")
    parser.add_argument("--batch_size", type=int, default=2, help="Image pairs per forward.")
    parser.add_argument("--bf16", action="store_true",
                        help="Run params and activations in bfloat16 (the fast path); .flo files stay float32.")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")
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


def run_dir(model, inputdir: str, savedir: str, is_pair: bool = False, start: int = 0,
            num_images: int = -1, batch_size: int = 1) -> list[str]:
    """Write one ``.flo`` per frame pair of ``inputdir``; batches consecutive pairs of one size."""
    os.makedirs(savedir, exist_ok=True)
    pairs = image_pairs(inputdir, is_pair, start, num_images)
    print(f"Processing {len(pairs)} pairs of images...", flush=True)
    written: list[str] = []
    batch: list[tuple[np.ndarray, np.ndarray, str]] = []

    def flush():
        flows = estimate(model, np.stack([b[0] for b in batch]),
                         np.stack([b[1] for b in batch])).float().cpu().numpy()
        for flow, (_, _, name) in zip(flows, batch):
            out = flowname_modifier(name, savedir, pair=False)
            write_flow(flow, out)
            written.append(out)
        batch.clear()

    for f1, f2 in pairs:
        im1, im2 = load_image(f1), load_image(f2)
        if batch and (len(batch) == batch_size or batch[0][0].shape != im1.shape):
            flush()
        batch.append((im1, im2, f1))
    if batch:
        flush()
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


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = config(args.model, args.version)
    factory = hui_liteflownet if args.model == "hui" else piv_liteflownet
    device = "cpu" if args.cpu else None
    weights, args.netname = load_weights(args, cfg)
    if weights is None:
        print("WARNING: no weight file found or given; using a seeded random init", flush=True)
    model = factory(weights, version=args.version, device=device)
    if args.bf16:
        model = model.to(torch.bfloat16)
        print("bfloat16 fast path enabled", flush=True)
    print(f"Running on {next(model.parameters()).device}", flush=True)
    for imdir in args.input:
        savedir, flodir, argsname = output_dirs(args, imdir)
        os.makedirs(savedir, exist_ok=True)
        with open(os.path.join(savedir, argsname), "w") as f:
            for argument, value in sorted(vars(args).items()):
                f.write(f"{argument}: {value}\n")
        run_dir(model, imdir, flodir, is_pair=args.is_pair, start=args.start,
                num_images=args.num_images, batch_size=args.batch_size)


if __name__ == "__main__":
    main()
