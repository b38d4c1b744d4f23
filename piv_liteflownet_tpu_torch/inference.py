"""The ``estimate()`` contract and the ``Inference`` class (port of
``piv_liteflownet_tpu/inference.py``).

1. both frames are cast to the dtype of the model's parameters (float32, or
   bfloat16 for the fast path) and resized bilinearly (align_corners=False)
   to the next multiple of 32;
2. one eval forward gives the scaled flow, float32 convs in full float32;
3. the flow is resized back to the input size, u scaled by W_in/W_32 and v
   by H_in/H_32, all in that dtype.

Inputs and outputs keep the JAX package's NHWC layout. Across ranks
(``parallel/mesh.py``, every rank calling with the same frames): ``mesh``
splits the batch, ``spatial_mesh`` each frame's height (``parallel/spatial.py``);
both return the whole result on every rank, as JAX returns a global array.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, LiteFlowNet, Ops
from piv_liteflownet_tpu_torch.ops.nn import device_constant, f32_convs
from piv_liteflownet_tpu_torch.ops.resize import resize_bilinear
from piv_liteflownet_tpu_torch.parallel.mesh import Mesh, gather_rows, split_rows
from piv_liteflownet_tpu_torch.utils.flow_io import flowname_modifier, image_files_from_folder, write_flow
from piv_liteflownet_tpu_torch.utils.profiling import ESTIMATE, ESTIMATE_IN, ESTIMATE_OUT, span


def adaptive_size(h: int, w: int, mult: int = 32) -> Tuple[int, int]:
    return int(math.ceil(h / mult) * mult), int(math.ceil(w / mult) * mult)


def to_nchw(img, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[B,H,W,C]`` numpy or tensor -> contiguous ``[B,C,H,W]`` of ``dtype`` on ``device``."""
    t = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.asarray(img, np.float32))
    return t.to(device=device, dtype=dtype).permute(0, 3, 1, 2).contiguous()


def _mesh_size(mesh: Optional[Mesh], axis: str) -> int:
    if mesh is None:
        return 1
    if not isinstance(mesh, Mesh) or mesh.axis != axis:
        raise ValueError(f"expected a parallel.mesh.Mesh with a {axis!r} axis, got {mesh!r}")
    return mesh.size


@torch.no_grad()
def estimate(model: LiteFlowNet, img1, img2, tensor: bool = False, ops: Ops = KERNEL_OPS,
             mesh: Optional[Mesh] = None, spatial_mesh: Optional[Mesh] = None):
    """Flow for one pair or a batch of pairs.

    img1/img2: ``[H,W,3]`` or ``[B,H,W,3]`` in [0, 1] (numpy or torch).
    Everything runs in the dtype of the model's parameters, as in the JAX
    package: float32, or bfloat16 after ``model.to(torch.bfloat16)`` (bf16
    convs through cuDNN, which sums in float32, or with ``conv_impl="chain"``
    the conv chain's bf16 form; the kernels' bf16 forms).
    Returns a ``[B,H,W,2]`` torch tensor of that dtype on the model's device
    (with ``tensor=True`` or a batch), else an ``[H,W,2]`` numpy array: of
    float32 for a bf16 model, holding the bf16 values exactly, because torch
    exports no bf16 to numpy (JAX returns an ``ml_dtypes`` bf16 array).
    ``ops`` selects the kernels (default) or their plain versions. float32
    convs run in full float32 whatever torch's TF32 flags say.

    ``mesh``: a ``data`` mesh; the batch is padded to a multiple of its ranks by repeating
    the last pair, each rank runs the whole pipeline on its rows, and the flows are gathered
    on every rank. ``spatial_mesh``: a ``spatial`` mesh; the /32 resize is raised to the next
    multiple of 32 x its ranks where needed, each frame's height is split over the ranks
    (``parallel/spatial.py:spatial_estimate``) and the flow is gathered before the resize
    back. The two are mutually exclusive; every rank of the mesh calls with the same frames.
    """
    with span(ESTIMATE):
        if tuple(img1.shape) != tuple(img2.shape):
            raise ValueError(f"both frames must have the same shape, got "
                             f"{tuple(img1.shape)} and {tuple(img2.shape)}")
        single = len(img1.shape) == 3
        if single:
            img1, img2 = img1[None], img2[None]
        if len(img1.shape) != 4 or img1.shape[-1] != 3:
            raise ValueError(f"expected [H,W,3] or [B,H,W,3] frames, got {tuple(img1.shape)}")
        param = next(model.parameters())
        device, dtype = param.device, param.dtype
        with f32_convs():
            with span(ESTIMATE_IN):
                x1, x2 = to_nchw(img1, device, dtype), to_nchw(img2, device, dtype)
                in_h, in_w = x1.shape[2], x1.shape[3]
                n, ns = _mesh_size(mesh, "data"), _mesh_size(spatial_mesh, "spatial")
                if mesh is not None and spatial_mesh is not None:
                    raise ValueError("mesh and spatial_mesh are mutually exclusive")
                ah, aw = adaptive_size(in_h, in_w)
                b = x1.shape[0]
                if mesh is not None:
                    pad = (-b) % n
                    if pad:
                        x1, x2 = (torch.cat([x, x[-1:].expand(pad, -1, -1, -1)]) for x in (x1, x2))
                    rows = split_rows(b + pad, n, mesh.rank)
                    x1, x2 = x1[rows], x2[rows]
                if spatial_mesh is not None:
                    from piv_liteflownet_tpu_torch.parallel.spatial import spatial_estimate

                    ah = -(-ah // (32 * ns)) * 32 * ns  # equal level-6 shards
                x1, x2 = resize_bilinear(x1, ah, aw), resize_bilinear(x2, ah, aw)
            if spatial_mesh is None:
                flow = model(x1, x2, ops)
            else:
                flow = spatial_estimate(model, x1, x2, spatial_mesh, ops=ops)
        with span(ESTIMATE_OUT):
            flow = resize_bilinear(flow, in_h, in_w)
            scale = device_constant((in_w / aw, in_h / ah), flow.dtype, device)
            flow = (flow * scale.view(1, 2, 1, 1)).permute(0, 2, 3, 1)
            if mesh is not None:
                flow = gather_rows(mesh, flow.contiguous())[:b]
        if tensor or not single:
            return flow
        return flow[0].float().cpu().numpy()


class Inference:
    """Directory, loader and video inference (port of ``piv_liteflownet_tpu/inference.py:Inference``).

    Outputs go to ``<output_dir>/<netname>/``: ``<dir>_parse/`` (``images_parsing``),
    ``<dir>_loader/`` (``dataloader_parsing``) and ``vid_<name>/`` (``video_parsing``).
    """

    def __init__(self, model: LiteFlowNet, netname: Optional[str] = None, output_dir: str = "./outputs",
                 batch_size: int = 1):
        self.netname = "test" if netname is None else os.path.splitext(os.path.basename(netname))[0]
        self.default = os.path.join(output_dir, self.netname)
        self.model = model
        self.batch_size = batch_size

    @staticmethod
    def parser(model: LiteFlowNet, im1, im2) -> np.ndarray:
        """The ``[H,W,2]`` flow of two frames (arrays or PIL images); frames whose first has a
        value above 1.5 are taken as 8-bit and divided by 255."""
        a1, a2 = np.asarray(im1, np.float32), np.asarray(im2, np.float32)
        if a1.max() > 1.5:
            a1, a2 = a1 / 255.0, a2 / 255.0
        if a1.shape != a2.shape:
            raise ValueError(f"both frames must have the same shape, got {a1.shape} and {a2.shape}")
        return estimate(model, a1, a2)

    def images_parsing(self, imgdir: str, pair: bool = True, write: bool = True) -> List[str]:
        """One flow per ``*_img1``/``*_img2`` pair (``pair``) or per consecutive frame pair of
        ``imgdir``, one pair at a time; returns the output names."""
        from PIL import Image

        if not os.path.isdir(imgdir):
            raise ValueError(f"Input directory is NOT found! At {imgdir}")
        outdir = os.path.join(self.default, os.path.basename(imgdir) + "_parse")
        os.makedirs(outdir, exist_ok=True)
        if pair:
            jobs = []
            for file1 in image_files_from_folder(imgdir, pair=True):
                fbase, fext = os.path.splitext(file1)
                file2 = fbase.rsplit("_", 1)[0] + "_img2" + fext
                if os.path.isfile(file2):
                    jobs.append((file1, file2))
        else:
            files = image_files_from_folder(imgdir, pair=False)
            jobs = list(zip(files[:-1], files[1:]))
        out_names = []
        for file1, file2 in jobs:
            with Image.open(file1) as f1, Image.open(file2) as f2:
                flow = self.parser(self.model, f1.convert("RGB"), f2.convert("RGB"))
            out_name = flowname_modifier(file1, outdir, pair=pair)
            if write:
                write_flow(flow, out_name)
            out_names.append(out_name)
        return out_names

    def dataloader_parsing(self, dir: str, pair: bool = True, write: bool = True) -> List[str]:
        """The pairs of ``dir`` through ``Run`` and ``BatchLoader`` in batches of
        ``batch_size``; returns the output names."""
        from piv_liteflownet_tpu_torch.data.datasets import Run
        from piv_liteflownet_tpu_torch.data.loader import BatchLoader

        if not os.path.isdir(dir):
            raise ValueError(f"Input directory is NOT found! At {dir}")
        outdir = os.path.join(self.default, os.path.basename(dir) + "_loader")
        os.makedirs(outdir, exist_ok=True)
        out_names = []
        for (im1, im2), names in BatchLoader(Run(root=dir, is_pair=pair), batch_size=self.batch_size):
            flows = estimate(self.model, im1, im2, tensor=True).float().cpu().numpy()
            for i, name in enumerate(names):
                out_name = flowname_modifier(name, outdir, pair=pair)
                if write:
                    write_flow(flows[i], out_name)
                out_names.append(out_name)
        return out_names

    def video_parsing(self, vidfile=0, write: bool = True) -> List[str]:
        """One flow per consecutive frame pair of a video file (or a capture device index),
        read with OpenCV (imported here: no other path needs it); returns the output names
        ``vid_<name>/<name>_<count:06d>_out.flo``."""
        import cv2

        if isinstance(vidfile, str) and not os.path.isfile(vidfile):
            raise ValueError(f"Input video file is NOT found! At {vidfile}")
        window_name = os.path.splitext(os.path.basename(vidfile))[0] if isinstance(vidfile, str) else "piv_stream"
        cap = cv2.VideoCapture(vidfile)
        outdir = os.path.join(self.default, f"vid_{window_name}")
        os.makedirs(outdir, exist_ok=True)
        count, out_names, prev = 0, [], None
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if prev is not None:
                    count += 1
                    flow = self.parser(self.model, prev, frame)
                    out_name = os.path.join(outdir, f"{window_name}_{count:06d}_out.flo")
                    if write:
                        write_flow(flow, out_name)
                    out_names.append(out_name)
                prev = frame
        finally:
            cap.release()
        return out_names
