"""Stereo-PIV CLI of the port: ``python -m piv_liteflownet_tpu_torch.stereo_run``.

The top-level ``stereo_run.py``'s flags, plus ``--cpu``. Each camera's 2D
flow is dewarped through its calibration coefficients (``nl_trans`` on the
flow values), scaled to physical units (``calib * fps``) and the two are
reconstructed into (U, V, W) by Willert's method, written as 3-band ``.flo``
files ``<save>/stereo/<base>-S_out.flo``. Three paths:

- ``flo_process`` (``--inference-mode manual`` without ``--root``): from
  per-camera ``<save>/left/*-L_out.flo`` and ``<save>/right/*-R_out.flo``;
- ``manual_process`` (``manual`` with ``--root``): ``estimate`` over
  ``<root>/left`` and ``<root>/right`` (``*_img1/_img2`` pairs, ``Run`` and
  ``BatchLoader``), the per-camera flows written, then ``flo_process``;
- ``direct_process`` (``direct``): ``InferenceRun(use_stereo=True)``, two
  ``estimate`` calls per stereo pair, and the reconstruction on the card: the
  flows stay there and one float32 ``[H,W,3]`` comes back per pair.

Weights: ``--model`` a ``.npz`` of JAX params or a ``.paramOnly`` torch
state dict (a path that does not exist raises); without it, a seeded random
init. Everything runs on the CUDA card unless ``--cpu`` is given. The dewarp
is float64 and its result float32, the scaling float32 and the
reconstruction float64, as the JAX package's numpy arithmetic.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob
from typing import List, Optional, Sequence

import numpy as np
import torch

from piv_liteflownet_tpu_torch.inference import estimate
from piv_liteflownet_tpu_torch.stereo.dewarp import nl_trans
from piv_liteflownet_tpu_torch.stereo.vel3d import willert
from piv_liteflownet_tpu_torch.utils.flow_io import flowname_modifier, read_flow, write_flow

CAMERAS = ("left", "right")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Stereoscopic PIV image processing")
    parser.add_argument("--coeff", "-c", type=str, required=True, help="mapping coefficient json file path.")
    parser.add_argument("--root", "-r", default=None, type=str, help="root directory for series of images")
    parser.add_argument("--save", "-s", default="./work", type=str, help="directory for saving")
    parser.add_argument("--theta", default=[45.0, 45.0], type=float, nargs="+", help="object plane angle")
    parser.add_argument("--alpha", default=[0.0, 0.0], type=float, nargs="+",
                        help="scheimpflug criterion, image plane angle")
    parser.add_argument("--window-size", "-ws", default=[1.0, 1.0], type=float, nargs="+",
                        help="Window size in the real length")
    parser.add_argument("--fps", default=1, type=int, help="camera frame rate (FPS).")
    parser.add_argument("--calib", default=None, type=float, help="real length calibration in meters (m).")
    parser.add_argument("--model", default=None, type=str, help="weight file (.paramOnly / .npz)")
    parser.add_argument("--model-version", default=1, type=int, choices=[1, 2])
    parser.add_argument("--inference-mode", default="manual", type=str, choices=["manual", "direct"])
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")
    return parser


def read_coeff(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


def _angles(args):
    """Degrees -> radians; the left camera gets negative angles."""
    beta, theta = [], []
    for i in range(2):
        sign = (-1) ** (i + 1)
        alpha_deg = args.alpha[0] if len(args.alpha) == 1 else args.alpha[i]
        theta_deg = args.theta[0] if len(args.theta) == 1 else args.theta[i]
        beta.append(sign * np.deg2rad(alpha_deg))
        theta.append(sign * np.deg2rad(theta_deg))
    return theta, beta


def _calib(coeffdict: dict, args) -> Optional[float]:
    """The physical scale: ``--calib`` over the plate's grid spacing, when both are given."""
    if "calib" in coeffdict and args.calib:
        return args.calib / coeffdict["calib"]
    return None


def _stereo_cal(flow: torch.Tensor, A, fps: float, calibrate: Optional[float] = None) -> torch.Tensor:
    """A camera's ``[H,W,2]`` flow dewarped through the mapping (its values, in float64, stored
    as float32) and scaled to physical units, on the flow's device."""
    u, v = nl_trans(flow[..., 0], flow[..., 1], A)
    flow_stereo = torch.stack([u, v], dim=-1).float()
    if calibrate:
        flow_stereo = flow_stereo * calibrate * fps
    return flow_stereo


def reconstruct(flows: Sequence[torch.Tensor], coeffdict: dict, theta, beta, fps: float,
                calibrate: Optional[float]) -> torch.Tensor:
    """The float32 ``[H,W,3]`` (U, V, W) of the left and right ``[H,W,2]`` flows, on their device."""
    flow_cal = [_stereo_cal(f, coeffdict[cam.capitalize()], fps, calibrate) for f, cam in zip(flows, CAMERAS)]
    return willert(flow_cal, theta, beta).float()


def flo_process(args, device: torch.device) -> List[str]:
    """Pair ``<save>/left/*.flo`` with ``<save>/right/<base>-R_out.flo``, reconstruct, write
    ``<save>/stereo/<base>-S_out.flo``; returns the files written."""
    coeffdict = read_coeff(args.coeff)
    theta, beta = _angles(args)
    calib = _calib(coeffdict, args)
    if not os.path.isdir(args.save):
        raise FileNotFoundError(f"no directory {args.save}")
    written = []
    for left_flo in sorted(glob(os.path.join(args.save, CAMERAS[0], "*.flo"))):
        flobase = os.path.basename(left_flo).rsplit("-", 1)[0]
        right_flo = os.path.join(args.save, CAMERAS[1], flobase + "-R_out.flo")
        if not os.path.isfile(right_flo):
            raise FileNotFoundError(f"{left_flo} has no right-camera flow {right_flo}")
        flows = [torch.from_numpy(read_flow(f)).to(device) for f in (left_flo, right_flo)]
        stereo_flow = reconstruct(flows, coeffdict, theta, beta, args.fps, calib)
        flosave = os.path.join(args.save, "stereo", f"{flobase}-S_out.flo")
        os.makedirs(os.path.dirname(flosave), exist_ok=True)
        write_flow(stereo_flow.cpu().numpy(), flosave)
        print(f"wrote {flosave}")
        written.append(flosave)
    return written


def _load_model(args, device: torch.device):
    from piv_liteflownet_tpu_torch.models.convert import load_param_only
    from piv_liteflownet_tpu_torch.models.factory import config, piv_liteflownet
    from piv_liteflownet_tpu_torch.utils.checkpoint import load_params_npz

    params = None
    if args.model:
        if not os.path.isfile(args.model):
            raise FileNotFoundError(f"no weight file {args.model}")
        cfg = config("piv", args.model_version)
        params = (load_params_npz(cfg, args.model) if args.model.endswith(".npz")
                  else load_param_only(cfg, args.model))
    return piv_liteflownet(params, version=args.model_version, device=device)


def manual_process(args, device: torch.device) -> List[str]:
    """Each camera's directory through ``estimate``, its flows written, then ``flo_process``."""
    from piv_liteflownet_tpu_torch.data.datasets import Run
    from piv_liteflownet_tpu_torch.data.loader import BatchLoader

    model = _load_model(args, device)
    for cam in CAMERAS:
        outdir = os.path.join(args.save, cam)
        os.makedirs(outdir, exist_ok=True)
        ds = Run(root=os.path.join(args.root, cam), is_pair=True)
        for (im1, im2), names in BatchLoader(ds, batch_size=args.batch_size):
            flows = estimate(model, im1, im2, tensor=True).float().cpu().numpy()
            for i, name in enumerate(names):
                write_flow(flows[i], flowname_modifier(name, outdir, pair=True))
    return flo_process(args, device)


def direct_process(args, device: torch.device) -> List[str]:
    """Both views of each stereo pair (``InferenceRun(use_stereo=True)``), two ``estimate`` calls
    and the reconstruction on the device; one ``[H,W,3]`` copied back per pair."""
    from piv_liteflownet_tpu_torch.data.datasets import InferenceRun

    model = _load_model(args, device)
    coeffdict = read_coeff(args.coeff)
    theta, beta = _angles(args)
    calib = _calib(coeffdict, args)
    ds = InferenceRun(root=args.root, pair=True, use_stereo=True)
    outdir = os.path.join(args.save, "stereo")
    os.makedirs(outdir, exist_ok=True)
    written = []
    for idx in range(len(ds)):
        (l1, l2, r1, r2), (lname, _) = ds[idx]
        flows = [estimate(model, a, b, tensor=True)[0] for a, b in ((l1, l2), (r1, r2))]
        stereo_flow = reconstruct(flows, coeffdict, theta, beta, args.fps, calib)
        flobase = os.path.splitext(os.path.basename(lname))[0].rsplit("-", 1)[0]
        flosave = os.path.join(outdir, f"{flobase}-S_out.flo")
        write_flow(stereo_flow.cpu().numpy(), flosave)
        print(f"wrote {flosave}")
        written.append(flosave)
    return written


def main(argv=None) -> List[str]:
    """Parse ``argv`` and run the chosen path; returns the ``-S_out.flo`` files written."""
    from piv_liteflownet_tpu_torch.models.factory import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if args.inference_mode == "direct":
        return direct_process(args, device)
    if args.root:
        return manual_process(args, device)
    return flo_process(args, device)  # from per-camera .flo files only


if __name__ == "__main__":
    main()
