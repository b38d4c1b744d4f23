"""Accuracy evaluation CLI of the port: end-point error of predicted flows against ground-truth
``.flo`` files (port of the JAX package's ``evaluate.py``)::

    python -m piv_liteflownet_tpu_torch.evaluate --input DIR [--flow_root DIR] --model piv \
        --version 1 [--params W] [--save OUT] [--viz] [--bf16] [--conv_impl chain] [--cpu]

``DIR`` holds ``*_img1/_img2`` pairs with ``<base>_flow.flo`` ground truth
(``InferenceEval``). Same-shape pairs are grouped into batches of
``--batch_size``. Prints one JSON line per pair (``pair``, ``epe_mean``,
``epe_max``) and then ``{"aggregate": {"pairs", "aee", "worst_pair_epe"}}``.
With ``--save`` the predicted ``.flo`` files are written there, and with
``--viz`` also their flow-colour PNGs. It runs on the CUDA card unless
``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="EPE evaluation of PIV-LiteFlowNet on a CUDA card")
    parser.add_argument("--input", "-i", required=True, help="image-pair directory")
    parser.add_argument("--flow_root", default=None, help="ground-truth .flo dir (default: input)")
    parser.add_argument("--model", "-m", choices=["hui", "piv"], default="piv")
    parser.add_argument("--version", "-v", type=int, choices=[1, 2], default=1)
    parser.add_argument("--params", type=str, default=None, help="a torch state dict file or .npz of JAX params")
    parser.add_argument("--save", "-s", default=None, help="write predicted .flo files here")
    parser.add_argument("--viz", action="store_true", help="also write flow-color PNGs")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--batch_size", "-b", type=int, default=8,
                        help="pairs per forward (same-shape pairs are grouped)")
    parser.add_argument("--conv_impl", choices=["cudnn", "chain"], default="cudnn",
                        help="The NetE conv stacks through cuDNN, or each through one conv_chain kernel.")
    return parser


def main(argv=None) -> dict:
    """Evaluate; returns the aggregate dict (the last line printed)."""
    from piv_liteflownet_tpu_torch.data.datasets import InferenceEval
    from piv_liteflownet_tpu_torch.inference import estimate
    from piv_liteflownet_tpu_torch.models.factory import config, hui_liteflownet, piv_liteflownet
    from piv_liteflownet_tpu_torch.run import load_weights
    from piv_liteflownet_tpu_torch.utils.flow_io import flowname_modifier, write_flow

    args = build_parser().parse_args(argv)
    factory = hui_liteflownet if args.model == "hui" else piv_liteflownet
    params = None
    if args.params:
        params, _ = load_weights(SimpleNamespace(params=args.params, model=args.model),
                                 config(args.model, args.version))
    model = factory(params, version=args.version, device="cpu" if args.cpu else None, conv_impl=args.conv_impl)
    if args.bf16:
        model = model.to(torch.bfloat16)

    ds = InferenceEval(args.input, flow_root=args.flow_root)
    if args.save:
        os.makedirs(args.save, exist_ok=True)
    results = [None] * len(ds)
    buffers: dict = {}

    def flush(chunk):
        preds = estimate(model, np.stack([c[1] for c in chunk]), np.stack([c[2] for c in chunk]),
                         tensor=True).float().cpu().numpy()
        for (idx, _, _, gt, name), pred in zip(chunk, preds):
            epe_map = np.linalg.norm(pred - gt, axis=-1)
            results[idx] = {"pair": os.path.basename(name), "epe_mean": float(epe_map.mean()),
                            "epe_max": float(epe_map.max())}
            if args.save:
                out_name = flowname_modifier(name, args.save, pair=True)
                write_flow(pred, out_name)
                if args.viz:
                    from PIL import Image

                    from piv_liteflownet_tpu_torch.utils.flow_viz import motion_to_color

                    Image.fromarray(motion_to_color(pred)[..., ::-1]).save(out_name.replace(".flo", ".png"))

    for idx in range(len(ds)):
        (im1, im2), gt, name = ds[idx]
        buf = buffers.setdefault(im1.shape, [])
        buf.append((idx, im1, im2, gt, name))
        if len(buf) >= args.batch_size:
            flush(buf)
            buf.clear()
    for buf in buffers.values():
        if buf:
            flush(buf)
    for rec in results:
        print(json.dumps(rec))
    agg = {"pairs": len(results),
           "aee": float(np.mean([r["epe_mean"] for r in results])) if results else None,
           "worst_pair_epe": float(max((r["epe_mean"] for r in results), default=0.0))}
    print(json.dumps({"aggregate": agg}), flush=True)
    return agg


if __name__ == "__main__":
    main()
