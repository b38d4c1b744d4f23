"""Stereo PIV: calibration-plate matching, rational dewarping and 2D3C reconstruction.

Port of ``piv_liteflownet_tpu/stereo``, with the same names.
"""

from piv_liteflownet_tpu_torch.stereo.vel3d import willert  # noqa: F401
from piv_liteflownet_tpu_torch.stereo.dewarp import nl_trans, warp_image, grid_regularize, map_coeff  # noqa: F401
from piv_liteflownet_tpu_torch.stereo.matching import (  # noqa: F401
    gen_template,
    template_matching,
    find_local_max,
)
