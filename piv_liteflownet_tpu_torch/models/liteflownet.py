"""LiteFlowNet (version 1) eval forward as PyTorch modules, NCHW.

Port of ``piv_liteflownet_tpu/models/liteflownet.py`` (``ModelConfig`` :60,
``param_shapes`` :201, ``_netc`` :473, ``_matching`` :498, ``_subpixel``
:571, ``_regularization`` :631, eval ``forward`` :716) for version 1. Module
and parameter names are the torch state-dict names of ``param_shapes``, so
JAX params carry across by layout transposes alone (``models/convert.py``).

The quirks the JAX package reproduces are kept: the ``NetC_ext`` index
(level 2 -> ext[0], level 1 -> ext[-1]); the stride-2 NetE-M path below
level 4, which warps and correlates only the even phase and then upsamples
the cost volume with ``upCorr_M``; leaky_relu on the cost volume; the
detached NetE-R occlusion norm; the rgb mean subtraction.

The three custom ops go through :class:`Ops`: :data:`KERNEL_OPS` (the
default) calls the wrappers that launch the CUDA kernels on CUDA tensors,
:data:`PLAIN_OPS` calls their plain PyTorch versions on any device, which is
the on-card reference for the kernels. Convs, deconvs, resize, unfold and
softmax stay cuDNN/PyTorch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from piv_liteflownet_tpu_torch.ops import correlation, rgb_warp, warp
from piv_liteflownet_tpu_torch.ops.nn import NEGATIVE_SLOPE, depthwise_deconv4x2, leaky_relu, unfold
from piv_liteflownet_tpu_torch.ops.resize import resize_bilinear

# Per-pyramid-level constants, indexed by actual level (1..6); index 0 unused.
KLAST = [0, 7, 7, 5, 5, 3, 3]      # last-conv kernel size of M/S, unfold size of R
PLAST = [0, 3, 3, 2, 2, 1, 1]      # its padding
RDIST = [0, 49, 49, 25, 25, 9, 9]  # R distance channels
FEAT_CH = [0, 32, 32, 64, 96, 128, 192]
S_IN_CH = [0, 130, 130, 130, 194, 258, 386]
R_IN_CH = [0, 131, 131, 131, 131, 131, 195]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    version: int = 1
    starting_scale: float = 40.0
    lowest_level: int = 2
    rgb_mean: Tuple[float, ...] = (
        0.411618, 0.434631, 0.454253, 0.410782, 0.433645, 0.452793,
    )

    def __post_init__(self):
        if self.version != 1:
            raise NotImplementedError(
                "only LiteFlowNet version 1 is ported; version 2 is queued in ROADMAP.md")

    @property
    def levels(self) -> List[int]:
        """Pyramid levels used, low to high."""
        return list(range(self.lowest_level, 7))

    @property
    def n_ext(self) -> int:
        """Number of ``NetC_ext`` modules."""
        return max(0, 2 - (self.lowest_level - 1))

    def scale_factor(self, level: int) -> float:
        return float(self.starting_scale) / (2.0 ** level)


def _conv_entry(name, kh, kw, cin, cout, bias=True, transpose_groups=None):
    return dict(name=name, kh=kh, kw=kw, cin=cin, cout=cout, bias=bias,
                transpose_groups=transpose_groups)


def param_shapes(cfg: ModelConfig) -> List[dict]:
    """Conv/deconv specs in state-dict order (port of ``param_shapes``, version 1)."""
    specs = [
        _conv_entry("NetC.conv1.0", 7, 7, 3, 32),
        _conv_entry("NetC.conv2.0", 3, 3, 32, 32),
        _conv_entry("NetC.conv2.2", 3, 3, 32, 32),
        _conv_entry("NetC.conv2.4", 3, 3, 32, 32),
        _conv_entry("NetC.conv3.0", 3, 3, 32, 64),
        _conv_entry("NetC.conv3.2", 3, 3, 64, 64),
        _conv_entry("NetC.conv4.0", 3, 3, 64, 96),
        _conv_entry("NetC.conv4.2", 3, 3, 96, 96),
        _conv_entry("NetC.conv5.0", 3, 3, 96, 128),
        _conv_entry("NetC.conv6.0", 3, 3, 128, 192),
    ]
    for j in range(cfg.n_ext):
        specs.append(_conv_entry(f"NetC_ext.{j}.conv_ext.0", 1, 1, 32, 64))
    for i, level in enumerate(cfg.levels):
        pfx = f"NetE_M.{i}"
        if level != 6:
            specs.append(_conv_entry(f"{pfx}.upConv_M", 4, 4, 2, 2, bias=False, transpose_groups=2))
        if level < 4:
            specs.append(_conv_entry(f"{pfx}.upCorr_M", 4, 4, 49, 49, bias=False, transpose_groups=49))
        for ci, (cin, cout) in enumerate([(49, 128), (128, 64), (64, 32), (32, 2)]):
            k = KLAST[level] if ci == 3 else 3
            specs.append(_conv_entry(f"{pfx}.conv_M.{2 * ci}", k, k, cin, cout))
    for i, level in enumerate(cfg.levels):
        for ci, (cin, cout) in enumerate([(S_IN_CH[level], 128), (128, 64), (64, 32), (32, 2)]):
            k = KLAST[level] if ci == 3 else 3
            specs.append(_conv_entry(f"NetE_S.{i}.conv_S.{2 * ci}", k, k, cin, cout))
    for i, level in enumerate(cfg.levels):
        pfx = f"NetE_R.{i}"
        if level < 5:
            specs.append(_conv_entry(f"{pfx}.moduleFeat.0", 1, 1, FEAT_CH[level], 128))
        r_chain = [(R_IN_CH[level], 128), (128, 128), (128, 64), (64, 64), (64, 32), (32, 32)]
        for ci, (cin, cout) in enumerate(r_chain):
            specs.append(_conv_entry(f"{pfx}.conv_R.{2 * ci}", 3, 3, cin, cout))
        k, d = KLAST[level], RDIST[level]
        if level < 5:
            specs.append(_conv_entry(f"{pfx}.conv_dist_R.0", k, 1, 32, d))
            specs.append(_conv_entry(f"{pfx}.conv_dist_R.1", 1, k, d, d))
        else:
            specs.append(_conv_entry(f"{pfx}.conv_dist_R.0", k, k, 32, d))
        specs.append(_conv_entry(f"{pfx}.moduleScaleX", 1, 1, d, 1))
        specs.append(_conv_entry(f"{pfx}.moduleScaleY", 1, 1, d, 1))
    return specs


@dataclasses.dataclass(frozen=True)
class Ops:
    """The three custom ops of the forward."""

    corr49: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    backwarp: Callable[..., torch.Tensor]
    rgb_warp_norm: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


KERNEL_OPS = Ops(correlation.corr49, warp.backwarp, rgb_warp.rgb_warp_norm)
PLAIN_OPS = Ops(correlation.corr49_plain, warp.backwarp_plain, rgb_warp.rgb_warp_norm_plain)


def _lrelu() -> nn.LeakyReLU:
    return nn.LeakyReLU(NEGATIVE_SLOPE)


def _conv_stack(chain, last_k: int = 3, last_pad: int = 1, last_act: bool = False) -> nn.Sequential:
    """3x3 convs with LeakyReLU between them; the last conv is ``last_k`` x ``last_k``."""
    layers: List[nn.Module] = []
    for ci, (cin, cout) in enumerate(chain):
        last = ci == len(chain) - 1
        k, p = (last_k, last_pad) if last else (3, 1)
        layers.append(nn.Conv2d(cin, cout, k, 1, p))
        if not last or last_act:
            layers.append(_lrelu())
    return nn.Sequential(*layers)


def _depthwise_up(c: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(c, c, 4, 2, 1, groups=c, bias=False)


class NetC(nn.Module):
    """6-level feature pyramid (port of ``_netc``)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(3, 32, 7, 1, 3), _lrelu())
        self.conv2 = nn.Sequential(
            nn.Conv2d(32, 32, 3, 2, 1), _lrelu(),
            nn.Conv2d(32, 32, 3, 1, 1), _lrelu(),
            nn.Conv2d(32, 32, 3, 1, 1), _lrelu())
        self.conv3 = nn.Sequential(
            nn.Conv2d(32, 64, 3, 2, 1), _lrelu(), nn.Conv2d(64, 64, 3, 1, 1), _lrelu())
        self.conv4 = nn.Sequential(
            nn.Conv2d(64, 96, 3, 2, 1), _lrelu(), nn.Conv2d(96, 96, 3, 1, 1), _lrelu())
        self.conv5 = nn.Sequential(nn.Conv2d(96, 128, 3, 2, 1), _lrelu())
        self.conv6 = nn.Sequential(nn.Conv2d(128, 192, 3, 2, 1), _lrelu())

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = [self.conv1(x)]
        for conv in (self.conv2, self.conv3, self.conv4, self.conv5, self.conv6):
            feats.append(conv(feats[-1]))
        return feats


class NetCExt(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_ext = nn.Sequential(nn.Conv2d(32, 64, 1, 1, 0), _lrelu())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_ext(x)


class Matching(nn.Module):
    """NetE-M descriptor matching (port of ``_matching``)."""

    def __init__(self, cfg: ModelConfig, level: int):
        super().__init__()
        self.level = level
        self.sf = cfg.scale_factor(level)
        if level != 6:
            self.upConv_M = _depthwise_up(2)
        if level < 4:
            self.upCorr_M = _depthwise_up(49)
        self.conv_M = _conv_stack([(49, 128), (128, 64), (64, 32), (32, 2)],
                                  KLAST[level], PLAST[level])

    def forward(self, f1, f2, flow: Optional[torch.Tensor], ops: Ops) -> torch.Tensor:
        if flow is not None:
            flow = depthwise_deconv4x2(flow, self.upConv_M.weight)
        if self.level >= 4:
            f2c = f2 if flow is None else ops.backwarp(f2, flow * self.sf)
            corr = leaky_relu(ops.corr49(f1, f2c))
        else:
            # Stride-2 cost volume: its taps are multiples of 2, so only the
            # even phase of both maps is warped and correlated.
            f1s = f1[:, :, ::2, ::2].contiguous()
            if flow is None:
                f2s = f2[:, :, ::2, ::2].contiguous()
            else:
                f2s = ops.backwarp(f2, (flow[:, :, ::2, ::2] * self.sf).contiguous(), 2)
            corr = depthwise_deconv4x2(leaky_relu(ops.corr49(f1s, f2s)), self.upCorr_M.weight)
        x = self.conv_M(corr)
        return x if flow is None else x + flow


class Subpixel(nn.Module):
    """NetE-S subpixel refinement (port of ``_subpixel``)."""

    def __init__(self, cfg: ModelConfig, level: int):
        super().__init__()
        self.sf = cfg.scale_factor(level)
        self.conv_S = _conv_stack([(S_IN_CH[level], 128), (128, 64), (64, 32), (32, 2)],
                                  KLAST[level], PLAST[level])

    def forward(self, f1, f2, flow: torch.Tensor, ops: Ops) -> torch.Tensor:
        f2w = ops.backwarp(f2, flow * self.sf)
        return self.conv_S(torch.cat([f1, f2w, flow], 1)) + flow


class Regularization(nn.Module):
    """NetE-R flow regularization (port of ``_regularization``)."""

    def __init__(self, cfg: ModelConfig, level: int):
        super().__init__()
        self.level = level
        self.sf = cfg.scale_factor(level)
        k, p, d = KLAST[level], PLAST[level], RDIST[level]
        if level < 5:
            self.moduleFeat = nn.Sequential(nn.Conv2d(FEAT_CH[level], 128, 1, 1, 0), _lrelu())
        self.conv_R = _conv_stack(
            [(R_IN_CH[level], 128), (128, 128), (128, 64), (64, 64), (64, 32), (32, 32)],
            last_act=True)
        if level < 5:
            self.conv_dist_R = nn.Sequential(
                nn.Conv2d(32, d, (k, 1), 1, (p, 0)), nn.Conv2d(d, d, (1, k), 1, (0, p)))
        else:
            self.conv_dist_R = nn.Sequential(nn.Conv2d(32, d, k, 1, p))
        self.moduleScaleX = nn.Conv2d(d, 1, 1, 1, 0)
        self.moduleScaleY = nn.Conv2d(d, 1, 1, 1, 0)

    def forward(self, img1, img2, feat1, flow: torch.Tensor, ops: Ops) -> torch.Tensor:
        k = KLAST[self.level]
        rm_flow = flow - flow.mean(dim=(2, 3), keepdim=True)
        norm = ops.rgb_warp_norm(img1, img2, flow * self.sf).detach()
        feat_r = self.moduleFeat(feat1) if self.level < 5 else feat1
        x = self.conv_dist_R(self.conv_R(torch.cat([norm, rm_flow, feat_r], 1)))
        negsq = -(x * x)
        dist = torch.exp(negsq - negsq.amax(dim=1, keepdim=True))
        divisor = 1.0 / dist.sum(dim=1, keepdim=True)
        sx = self.moduleScaleX(dist * unfold(flow[:, 0:1], k)) * divisor
        sy = self.moduleScaleY(dist * unfold(flow[:, 1:2], k)) * divisor
        return torch.cat([sx, sy], 1)


class LiteFlowNet(nn.Module):
    """LiteFlowNet version 1; ``forward`` is the eval forward."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.NetC = NetC()
        self.NetC_ext = nn.ModuleList([NetCExt() for _ in range(cfg.n_ext)])
        self.NetE_M = nn.ModuleList([Matching(cfg, lv) for lv in cfg.levels])
        self.NetE_S = nn.ModuleList([Subpixel(cfg, lv) for lv in cfg.levels])
        self.NetE_R = nn.ModuleList([Regularization(cfg, lv) for lv in cfg.levels])

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Torch's default conv init, ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, drawn from ``generator``.

        The draws are made on the CPU in ``param_shapes`` order, so a seed
        gives the same weights on every device.
        """
        for spec in param_shapes(self.cfg):
            kk = spec["kh"] * spec["kw"]
            groups = spec["transpose_groups"]
            fan_in = spec["cin"] * kk if groups is None else (spec["cout"] // groups) * kk
            bound = 1.0 / math.sqrt(fan_in)
            names = [spec["name"] + ".weight"] + ([spec["name"] + ".bias"] if spec["bias"] else [])
            for name in names:
                p = self.get_parameter(name)
                draw = torch.empty(p.shape, dtype=torch.float32).uniform_(
                    -bound, bound, generator=generator)
                p.copy_(draw)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                ops: Ops = KERNEL_OPS) -> torch.Tensor:
        """``img1, img2 [B,3,H,W]`` in [0, 1], H and W multiples of 32 -> flow ``[B,2,H',W']``.

        ``H' = H / 2**(lowest_level-1)``; the flow is scaled by ``scale_factor(1)``.
        """
        cfg = self.cfg
        mean = torch.tensor(cfg.rgb_mean, dtype=img1.dtype, device=img1.device)
        x1 = (img1 - mean[:3].view(1, 3, 1, 1)).contiguous()
        x2 = (img2 - mean[3:].view(1, 3, 1, 1)).contiguous()
        feat1 = self.NetC(x1)
        feat2 = self.NetC(x2)
        pyr1, pyr2 = [x1], [x2]
        for li in range(1, 6):
            h, w = feat1[li].shape[2], feat1[li].shape[3]
            pyr1.append(resize_bilinear(pyr1[-1], h, w))
            pyr2.append(resize_bilinear(pyr2[-1], h, w))

        flow = None
        for level in reversed(cfg.levels):
            i = level - cfg.lowest_level  # module list index
            li = level - 1                # feature / pyramid list index
            if level <= 2:
                # reference quirk: level 2 -> ext[0], level 1 -> ext[-1]
                ext = self.NetC_ext[0 if level == 2 else cfg.n_ext - 1]
                f1_in, f2_in = ext(feat1[li]), ext(feat2[li])
            else:
                f1_in, f2_in = feat1[li], feat2[li]
            flow = self.NetE_M[i](f1_in, f2_in, flow, ops)
            flow = self.NetE_S[i](f1_in, f2_in, flow, ops)
            flow = self.NetE_R[i](pyr1[li], pyr2[li], feat1[li], flow, ops)
        return flow * cfg.scale_factor(1)
