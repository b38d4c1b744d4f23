"""The spatial-sharding context: tells the model's forward that its maps are H-sharded.

Port of ``piv_liteflownet_tpu/parallel/ctx.py``. ``parallel/spatial.py:spatial_estimate``
sets it around the forward; ``models/liteflownet.py`` reads it at each op with a
vertical stencil, each warp and the flow's mean, so that no mesh is threaded through
the layer calls. JAX reads it at trace time; here it is read at each call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, Optional

from piv_liteflownet_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class SpatialCtx:
    """``mesh``: the ranks the frame's rows are split over, in order. ``halo``: the rows a warp
    exchanges with each neighbour; the halo warp is exact while every ``|v| < halo`` (checked
    over all ranks; else the warp gathers the whole map). ``halo_warp`` False: every warp
    gathers the whole map (JAX's ``spatial_estimate(halo_warp=False)``)."""

    mesh: Mesh
    axis: str = "spatial"
    halo: int = 32
    halo_warp: bool = True


_tls = threading.local()


def get_spatial_ctx() -> Optional[SpatialCtx]:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def spatial_context(mesh: Mesh, axis: str = "spatial", halo: int = 32,
                    halo_warp: bool = True) -> Iterator[SpatialCtx]:
    prev = get_spatial_ctx()
    _tls.ctx = SpatialCtx(mesh, axis, halo, halo_warp)
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev
