"""Stereo calibration CLI of the port: ``python -m piv_liteflownet_tpu_torch.stereo_cal``.

The top-level ``stereo_cal.py``'s flags, plus ``--cpu``. Per camera
(``<name>-L`` / ``<name>-R`` images under ``--root``, read with PIL as grey):

1. match a cross template over the calibration plate (``template_matching``,
   on the card unless ``--cpu``: no OpenCV);
2. take the cross centres as the map's connected components' centroids;
3. pick 4 reference points (matplotlib's ``ginput`` by default, or
   ``--clicks x1 y1 x2 y2 x3 y3 x4 y4`` for scripted runs);
4. snap the detected grid to the ideal one (``grid_regularize``);
5. fit the 24 rational-quadratic mapping coefficients (``map_coeff``);
6. write ``<save>/<name>_coeff.json`` with ``Left``, ``Right`` and, if
   given, ``calib``, which ``stereo_run --coeff`` reads.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".ppm")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="2D reconstruction method for Stereoscopic PIV calibration")
    parser.add_argument("--root", "-r", default="./imgs", type=str, help="root directory for the input images")
    parser.add_argument("--name", "-n", default="30-5_0", type=str, help="stereo image input names")
    parser.add_argument("--save", "-s", default="./work", type=str, help="directory for saving")
    parser.add_argument("--threshold", type=float, default=0.7, help="template-match threshold")
    parser.add_argument("--template", type=int, nargs=3, default=[5, 25, 25],
                        help="cross template (thickness, height, width)")
    parser.add_argument("--clicks", type=float, nargs=8, default=None,
                        help="non-interactive 4 reference points: x1 y1 ... x4 y4 (clockwise from TL)")
    parser.add_argument("--calib", type=float, default=None,
                        help="physical grid spacing in meters (stored in the json)")
    parser.add_argument("--cpu", action="store_true", help="Match on the CPU instead of the card.")
    return parser


def read_image_names(root: str, name: str):
    """The ``<name>-L.<ext>`` / ``<name>-R.<ext>`` pair under ``root``, for the first extension that
    has both."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no directory {root}")
    for ext in IMAGE_EXTS:
        pair = [os.path.join(root, f"{name}{idcam}{ext}") for idcam in ("-L", "-R")]
        if all(os.path.isfile(p) for p in pair):
            return pair
    raise FileNotFoundError(f"no {name}-L/-R image pair under {root}")


def detect_crosses(gray: np.ndarray, args, device: torch.device) -> np.ndarray:
    """The cross centres ``[N,2]`` (x, y) of the grey plate image ``gray``."""
    from piv_liteflownet_tpu_torch.stereo.matching import find_local_max, gen_template, template_matching

    tc, hc, lc = args.template
    template = gen_template(TC=tc, HC=hc, LC=lc)
    corr = template_matching(torch.from_numpy(gray).to(device), template, threshold=args.threshold)
    return find_local_max(corr)


def calibrate_camera(img_path: str, args, device: torch.device):
    """Detect crosses, regularize the grid, fit the mapping; returns ``(A, coords, new_pts, pt1)``."""
    from PIL import Image

    from piv_liteflownet_tpu_torch.stereo.dewarp import grid_regularize, map_coeff
    from piv_liteflownet_tpu_torch.stereo.matching import select_ref, select_ref_points

    with Image.open(img_path) as im:
        gray = np.array(im.convert("L"))
    coords = detect_crosses(gray, args, device)
    print(f"{os.path.basename(img_path)}: {len(coords)} cross points detected")

    if args.clicks is not None:
        clicks = [tuple(args.clicks[i: i + 2]) for i in range(0, 8, 2)]
        points_ref, selected, c_point = select_ref_points(coords, clicks)
    else:  # interactive
        import matplotlib.pyplot as plt

        plt.imshow(gray, cmap="gray")
        plt.scatter(coords[:, 0], coords[:, 1], s=4, c="r")
        print("Click the 4 reference points clockwise (TL, TR, BR, BL)...")
        points_ref, selected, c_point = select_ref(coords)
        plt.close()

    pt1 = selected[0]
    new_pts = grid_regularize(coords, c_point, pt1)
    A = map_coeff(coords, new_pts, pt1)
    return A, coords, new_pts, pt1


def main(argv=None) -> dict:
    """Calibrate both cameras and write the coefficients; returns what was written, and under
    ``"points"`` each camera's ``(coords, new_pts, pt1)``."""
    from piv_liteflownet_tpu_torch.models.factory import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    imnames = read_image_names(args.root, args.name)
    coeffdict, points = {}, {}
    for img_path, cam in zip(imnames, ("Left", "Right")):
        A, coords, new_pts, pt1 = calibrate_camera(img_path, args, device)
        coeffdict[cam] = [float(x) for x in A]
        points[cam] = (coords, new_pts, pt1)
    if args.calib is not None:
        coeffdict["calib"] = args.calib

    os.makedirs(args.save, exist_ok=True)
    out = os.path.join(args.save, f"{args.name}_coeff.json")
    with open(out, "w") as f:
        json.dump(coeffdict, f, indent=2)
    print(f"wrote {out}")
    return dict(coeffdict, points=points)


if __name__ == "__main__":
    main()
