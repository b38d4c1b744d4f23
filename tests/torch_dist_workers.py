"""Rank functions for the port's multi-rank tests (``tests/test_torch_parallel.py``,
``tests/test_torch_spatial.py``), run by ``parallel/mesh.py:spawn``.

Each spawned rank imports this module anew, so it imports neither jax nor the JAX
package: the tests compute the JAX references in their own process and pass numpy
arrays in. Each function takes the rank's ``Mesh`` first and returns numpy arrays
and plain values.
"""

from __future__ import annotations

import numpy as np
import torch

from piv_liteflownet_tpu_torch.models.factory import CONFIGS
from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS, LiteFlowNet


def write_pairs(root, n: int, h: int = 64, w: int = 96, seed: int = 0) -> str:
    """``n`` grey 8-bit ``p<i>_img1/_img2.png`` pairs under ``root``, the second frame shifted by
    a pixel or three (for the CLI tests)."""
    import os

    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.random((h + 8, w + 8))
    for i in range(n):
        for tag, (dy, dx) in (("img1", (0, 0)), ("img2", (1 + i % 3, 2))):
            f = (np.clip(base[dy:dy + h, dx:dx + w] + 0.05 * rng.random((h, w)), 0, 1) * 255).astype(np.uint8)
            Image.fromarray(np.repeat(f[..., None], 3, -1)).save(os.path.join(root, f"p{i:02d}_{tag}.png"))
    return str(root)


def model_from(family: str, version: int, state: dict, conv_impl: str = "cudnn", device="cpu",
               dtype=torch.float32) -> LiteFlowNet:
    import dataclasses

    model = LiteFlowNet(dataclasses.replace(CONFIGS[family, version], conv_impl=conv_impl))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.to(device=device, dtype=dtype).eval()


def spatial_forward(mesh, version: int, state: dict, img1: np.ndarray, img2: np.ndarray, halo: int,
                    halo_warp: bool = True) -> dict:
    """``spatial_estimate`` of NCHW float32 frames with the plain ops; the flow and this rank's
    traffic."""
    from piv_liteflownet_tpu_torch.ops.nn import f32_convs
    from piv_liteflownet_tpu_torch.parallel.spatial import spatial_estimate

    model = model_from("piv", version, state, device=mesh.device)
    x1, x2 = (torch.from_numpy(a).to(mesh.device) for a in (img1, img2))
    mesh.traffic.reset()
    with torch.no_grad(), f32_convs():
        flow = spatial_estimate(model, x1, x2, mesh, halo=halo, halo_warp=halo_warp, ops=PLAIN_OPS)
    return {"flow": flow.cpu().numpy(), "halo": list(mesh.traffic.halo), "gathers": list(mesh.traffic.gathers)}


def _flat(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def train_case(mesh, family: str, version: int, state: dict, batch: tuple, lr: float = 1e-4,
               compute_dtype=None, remat: bool = False, pipeline=None, seed: int = 0, steps: int = 1) -> dict:
    """``steps`` data-parallel train steps (plain ops on the CPU) from ``state`` on this rank's rows
    of the global NHWC ``batch``. Returns the loss and EPE of each step; rank 0 also the
    parameters after and the last step's gradients; every rank the largest difference of its
    parameters from rank 0's."""
    from piv_liteflownet_tpu_torch.parallel.mesh import broadcast, shard_rows
    from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_train_step
    from piv_liteflownet_tpu_torch.training.loss import piv_loss
    from piv_liteflownet_tpu_torch.training.optim import make_optimizer

    model = model_from(family, version, state, device=mesh.device)
    if mesh.rank:  # the step's broadcast must bring rank 0's parameters
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    opt = make_optimizer(model, model.cfg.lowest_level, lr=lr)
    step = make_train_step(model.cfg, piv_loss(version=version) if version == 1 else _v2_loss(), opt,
                           ops=PLAIN_OPS, mesh=mesh, pipeline=pipeline, remat=remat, compute_dtype=compute_dtype)
    st = TrainState(model, opt)
    losses = []
    for i in range(steps):
        st, metrics = step(st, *(shard_rows(mesh, a) for a in batch), seed + i)
        losses.append((float(metrics["loss"]), float(metrics["epe"])))
    flat = _flat(model)
    out = {"losses": losses}
    if mesh.rank == 0:
        out["params"] = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
        out["grads"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    ref = broadcast(mesh, flat.clone())
    out["max_diff_from_rank0"] = float((flat - ref).abs().max())
    return out


def _v2_loss():
    from piv_liteflownet_tpu_torch.training.loss import v2_multiscale

    return v2_multiscale()


def eval_case(mesh, state: dict, batch: tuple, rows=None) -> dict:
    """The data-parallel eval step (piv v1, piv loss) on ``rows`` of the global ``batch``
    (default: this rank's even share)."""
    from piv_liteflownet_tpu_torch.parallel.mesh import shard_rows
    from piv_liteflownet_tpu_torch.parallel.train_step import make_eval_step
    from piv_liteflownet_tpu_torch.training.loss import piv_loss

    model = model_from("piv", 1, state, device=mesh.device)
    step = make_eval_step(model.cfg, piv_loss(), mesh=mesh)
    mine = tuple(a[rows[mesh.rank]] if rows else shard_rows(mesh, a) for a in batch)
    metrics = step(model, *mine)
    return {k: float(v) for k, v in metrics.items()}


def estimate_case(mesh, state: dict, img1: np.ndarray, img2: np.ndarray, version: int = 1) -> np.ndarray:
    """``estimate(mesh=...)`` of the whole NHWC batch on every rank (plain ops)."""
    from piv_liteflownet_tpu_torch.inference import estimate

    model = model_from("piv", version, state, device=mesh.device)
    return estimate(model, img1, img2, tensor=True, ops=PLAIN_OPS, mesh=mesh).numpy()


def many(mesh, calls) -> list:
    """Several of this module's rank functions in one spawn: ``calls`` is a list of ``(name,
    args, kwargs)``; returns their results in order."""
    return [globals()[name](mesh, *args, **kwargs) for name, args, kwargs in calls]


def warp_case(mesh, img: np.ndarray, flow: np.ndarray, halo: int, stride: int) -> dict:
    """The model's sharded warp (``parallel/spatial.py:spatial_backwarp``) of this rank's rows of
    the NCHW ``img`` and ``flow``, with the plain warp; the output gathered, and the traffic."""
    from piv_liteflownet_tpu_torch.ops import warp
    from piv_liteflownet_tpu_torch.parallel.ctx import SpatialCtx
    from piv_liteflownet_tpu_torch.parallel.mesh import all_gather, split_rows
    from piv_liteflownet_tpu_torch.parallel.spatial import spatial_backwarp

    n, r = mesh.size, mesh.rank
    x = torch.from_numpy(img)[:, :, split_rows(img.shape[2], n, r)].contiguous()
    f = torch.from_numpy(flow)[:, :, split_rows(flow.shape[2], n, r)].contiguous()
    mesh.traffic.reset()
    out = spatial_backwarp(SpatialCtx(mesh, halo=halo), x, f, stride, warp.backwarp)
    return {"out": all_gather(mesh, out, 2).numpy(), "halo": list(mesh.traffic.halo),
            "gathers": list(mesh.traffic.gathers)}


def spatial_estimate_case(mesh, version: int, state: dict, img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
    """``estimate(spatial_mesh=...)`` of NHWC frames (plain ops), on every rank."""
    from piv_liteflownet_tpu_torch.inference import estimate

    model = model_from("piv", version, state, device=mesh.device)
    return estimate(model, img1, img2, tensor=True, ops=PLAIN_OPS, spatial_mesh=mesh).numpy()
