"""LiteFlowNet (version 1) and LiteFlowNet2 (version 2) as PyTorch modules, NCHW: the eval and
the train forward.

Port of ``piv_liteflownet_tpu/models/liteflownet.py`` (``ModelConfig`` :60,
``param_shapes`` :201, ``_netc`` :473, ``_matching`` :498, ``_subpixel``
:571, ``_regularization`` :631, ``forward`` :716). Version 2 has 6-conv
NetE-M and NetE-S stacks instead of 4, and its train forward appends the
final flow resized to the input. Module and parameter names are the torch
state-dict names of ``param_shapes``, so JAX params carry across by layout
transposes alone (``models/convert.py``).

The quirks the JAX package reproduces are kept: the ``NetC_ext`` index
(level 2 -> ext[0], level 1 -> ext[-1]); the stride-2 NetE-M path below
level 4, which warps and correlates only the even phase and then upsamples
the cost volume with ``upCorr_M``; leaky_relu on the cost volume; the
detached NetE-R occlusion norm; the rgb mean subtraction.

The four custom ops go through :class:`Ops`: :data:`KERNEL_OPS` (the
default) calls the wrappers that launch the CUDA kernels on CUDA tensors,
:data:`PLAIN_OPS` calls their plain PyTorch versions on any device, which is
the on-card reference for the kernels. On CUDA the cost volume and the
warp are ``torch.autograd.Function``s whose backward is a kernel as well
(``csrc/corr49_bwd.cu``, ``csrc/backwarp_bwd.cu``); the occlusion norm has no
gradient. With ``ModelConfig.conv_impl="chain"`` the eval forward runs each
NetE-M/S/R conv stack of a level of at least 32x32 as one ``conv_chain``
(``csrc/conv_chain.cu``, forward only, in the params' dtype: float32 or
bf16); otherwise, and always in the train forward, the stacks are cuDNN
convs. Convs, deconvs, resize, unfold and softmax stay cuDNN/PyTorch.

Under the spatial context of ``parallel/ctx.py`` (``parallel/spatial.py``) every
map is this rank's rows of an H-sharded map: each op or conv stack that reads
across rows runs on rows extended from the neighbours (:func:`_rows`), the warps
take ``parallel/spatial.py:spatial_backwarp``, NetE-R's flow mean is a mean over
all ranks and its occlusion norm the warp's (K4) then the norm, as in JAX. Without
the context these helpers are the plain calls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from piv_liteflownet_tpu_torch.ops import conv_chain, correlation, rgb_warp, warp
from piv_liteflownet_tpu_torch.ops.nn import NEGATIVE_SLOPE, depthwise_deconv4x2, device_constant, leaky_relu, unfold
from piv_liteflownet_tpu_torch.ops.resize import resize_bilinear
from piv_liteflownet_tpu_torch.parallel import spatial
from piv_liteflownet_tpu_torch.parallel.ctx import get_spatial_ctx
from piv_liteflownet_tpu_torch.utils.profiling import MODEL, NETC, PYRAMID, level_spans, span

# Per-pyramid-level constants, indexed by actual level (1..6); index 0 unused.
KLAST = [0, 7, 7, 5, 5, 3, 3]      # last-conv kernel size of M/S, unfold size of R
PLAST = [0, 3, 3, 2, 2, 1, 1]      # its padding
RDIST = [0, 49, 49, 25, 25, 9, 9]  # R distance channels
FEAT_CH = [0, 32, 32, 64, 96, 128, 192]
S_IN_CH = [0, 130, 130, 130, 194, 258, 386]
R_IN_CH = [0, 131, 131, 131, 131, 131, 195]
#: ``conv_impl`` values; the JAX package calls them "xla" and "pallas".
CONV_IMPLS = ("cudnn", "chain")
#: A level takes the conv chain only when its H and W are both at least this.
CHAIN_MIN_SIZE = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """``version``: 1 (LiteFlowNet) or 2 (LiteFlowNet2).

    ``conv_impl``: how the eval forward runs the NetE conv stacks. "cudnn"
    (the default; JAX's "xla") is one cuDNN conv per layer. "chain" (JAX's
    "pallas") runs each stack of a level of at least 32x32 as one
    ``conv_chain`` kernel; the train forward always takes "cudnn".
    """

    version: int = 1
    starting_scale: float = 40.0
    lowest_level: int = 2
    rgb_mean: Tuple[float, ...] = (
        0.411618, 0.434631, 0.454253, 0.410782, 0.433645, 0.452793,
    )
    conv_impl: str = "cudnn"

    def __post_init__(self):
        if self.version not in (1, 2):
            raise ValueError(f"LiteFlowNet version must be 1 or 2, got {self.version}")
        if self.conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {self.conv_impl!r}")

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


def m_chain(version: int) -> List[Tuple[int, int]]:
    """``(cin, cout)`` of each conv of the NetE-M stack: 4 convs in version 1, 6 in version 2."""
    if version == 1:
        return [(49, 128), (128, 64), (64, 32), (32, 2)]
    return [(49, 128), (128, 128), (128, 96), (96, 64), (64, 32), (32, 2)]


def s_chain(level: int, version: int) -> List[Tuple[int, int]]:
    """The NetE-S stack: the NetE-M stack reading the level's ``S_IN_CH`` channels."""
    return [(S_IN_CH[level], 128)] + m_chain(version)[1:]


def r_chain(level: int) -> List[Tuple[int, int]]:
    """The NetE-R stack, 3x3 convs with LeakyReLU after each, the last one included."""
    return [(R_IN_CH[level], 128), (128, 128), (128, 64), (64, 64), (64, 32), (32, 32)]


def param_shapes(cfg: ModelConfig) -> List[dict]:
    """Conv/deconv specs in state-dict order (port of ``param_shapes``)."""
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
        chain = m_chain(cfg.version)
        for ci, (cin, cout) in enumerate(chain):
            k = KLAST[level] if ci == len(chain) - 1 else 3
            specs.append(_conv_entry(f"{pfx}.conv_M.{2 * ci}", k, k, cin, cout))
    for i, level in enumerate(cfg.levels):
        chain = s_chain(level, cfg.version)
        for ci, (cin, cout) in enumerate(chain):
            k = KLAST[level] if ci == len(chain) - 1 else 3
            specs.append(_conv_entry(f"NetE_S.{i}.conv_S.{2 * ci}", k, k, cin, cout))
    for i, level in enumerate(cfg.levels):
        pfx = f"NetE_R.{i}"
        if level < 5:
            specs.append(_conv_entry(f"{pfx}.moduleFeat.0", 1, 1, FEAT_CH[level], 128))
        for ci, (cin, cout) in enumerate(r_chain(level)):
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
    """The four custom ops of the forward."""

    corr49: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    backwarp: Callable[..., torch.Tensor]
    rgb_warp_norm: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    conv_chain: Callable[..., torch.Tensor]


KERNEL_OPS = Ops(correlation.corr49, warp.backwarp, rgb_warp.rgb_warp_norm, conv_chain.conv_chain)
PLAIN_OPS = Ops(correlation.corr49_plain, warp.backwarp_plain, rgb_warp.rgb_warp_norm_plain,
                conv_chain.conv_chain_plain)


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


def _run_stack(stack: nn.Sequential, parts: List[torch.Tensor], ops: Ops, chain: bool) -> torch.Tensor:
    """``stack`` over the channel concat of ``parts``: as one ``ops.conv_chain`` when ``chain`` is
    set and the level is at least ``CHAIN_MIN_SIZE`` square (JAX ``_use_pallas_convs``), else as
    its cuDNN convs."""
    h, w = parts[0].shape[2:]
    if chain and h >= CHAIN_MIN_SIZE and w >= CHAIN_MIN_SIZE:
        convs = [m for m in stack if isinstance(m, nn.Conv2d)]
        last_linear = not isinstance(stack[-1], nn.LeakyReLU)
        return ops.conv_chain(parts, [c.weight for c in convs], [c.bias for c in convs], last_linear)
    return stack(parts[0] if len(parts) == 1 else torch.cat(parts, 1))


def _stencil(seq: nn.Sequential) -> Tuple[int, int]:
    """``(halo, stride)`` of a stack of convs: the input rows beyond a shard's, above and below,
    that its output rows read, rounded up to a multiple of its stride; and its stride."""
    halo, stride = 0, 1
    for m in reversed(seq):
        if isinstance(m, nn.Conv2d):
            k, s, p = m.kernel_size[0], m.stride[0], m.padding[0]
            halo, stride = halo * s + max(p, k - 1 - p), stride * s
    return -(-halo // stride) * stride, stride


def _rows(fn: Callable, xs: List[torch.Tensor], halo: int, down: int = 1, up: int = 1,
          label: str = "") -> torch.Tensor:
    """``fn(*xs)``; under the spatial context on this rank's rows extended by ``halo`` rows each
    side and cropped back (``parallel/spatial.py:on_slab``)."""
    ctx = get_spatial_ctx()
    if ctx is None:
        return fn(*xs)
    return spatial.on_slab(ctx, fn, xs, halo, down, up, label)


def _warp(ops: "Ops", img: torch.Tensor, flow: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``ops.backwarp``; under the spatial context the sharded warp (halo exchange or gather)."""
    ctx = get_spatial_ctx()
    if ctx is None:
        return ops.backwarp(img, flow) if stride == 1 else ops.backwarp(img, flow, stride)
    return spatial.spatial_backwarp(ctx, img, flow, stride, ops.backwarp)


def _call(module: nn.Module, remat: bool, *args):
    """``module(*args)``; with ``remat`` under ``torch.utils.checkpoint``, its activations dropped
    and recomputed in the backward.

    The recompute calls the module on the parameters it sees now: under the bf16 step's
    ``functional_call`` these are the bf16 casts, which are gone from the module by the time the
    backward runs.
    """
    if not remat:
        return module(*args)
    params = dict(module.named_parameters())
    return checkpoint(lambda *a: functional_call(module, params, a), *args, use_reentrant=False)


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
        feats = []
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4, self.conv5, self.conv6):
            halo, stride = _stencil(conv)
            feats.append(_rows(conv, [feats[-1] if feats else x], halo, stride, label="NetC"))
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
        self.conv_M = _conv_stack(m_chain(cfg.version), KLAST[level], PLAST[level])

    def forward(self, f1, f2, flow: Optional[torch.Tensor], ops: Ops, chain: bool = False) -> torch.Tensor:
        if flow is not None:
            flow = _rows(lambda f: depthwise_deconv4x2(f, self.upConv_M.weight), [flow], 1, up=2,
                         label="upConv_M")
        halo = _stencil(self.conv_M)[0]
        if self.level >= 4:
            f2c = f2 if flow is None else _warp(ops, f2, flow * self.sf)
            # the cost volume reads 3 rows each side, the stack its halo
            x = _rows(lambda a, b: _run_stack(self.conv_M, [leaky_relu(ops.corr49(a, b))], ops, chain),
                      [f1, f2c], halo + 3, label="NetE-M")
        else:
            # Stride-2 cost volume: its taps are multiples of 2, so only the
            # even phase of both maps is warped and correlated.
            f1s = f1[:, :, ::2, ::2].contiguous()
            if flow is None:
                f2s = f2[:, :, ::2, ::2].contiguous()
            else:
                f2s = _warp(ops, f2, (flow[:, :, ::2, ::2] * self.sf).contiguous(), 2)
            corr = _rows(lambda a, b: depthwise_deconv4x2(leaky_relu(ops.corr49(a, b)), self.upCorr_M.weight),
                         [f1s, f2s], 4, up=2, label="cost volume")
            x = _rows(lambda c: _run_stack(self.conv_M, [c], ops, chain), [corr], halo, label="NetE-M")
        return x if flow is None else x + flow


class Subpixel(nn.Module):
    """NetE-S subpixel refinement (port of ``_subpixel``)."""

    def __init__(self, cfg: ModelConfig, level: int):
        super().__init__()
        self.sf = cfg.scale_factor(level)
        self.conv_S = _conv_stack(s_chain(level, cfg.version), KLAST[level], PLAST[level])

    def forward(self, f1, f2, flow: torch.Tensor, ops: Ops, chain: bool = False) -> torch.Tensor:
        f2w = _warp(ops, f2, flow * self.sf)
        x = _rows(lambda a, b, c: _run_stack(self.conv_S, [a, b, c], ops, chain), [f1, f2w, flow],
                  _stencil(self.conv_S)[0], label="NetE-S")
        return x + flow


class Regularization(nn.Module):
    """NetE-R flow regularization (port of ``_regularization``)."""

    def __init__(self, cfg: ModelConfig, level: int):
        super().__init__()
        self.level = level
        self.sf = cfg.scale_factor(level)
        k, p, d = KLAST[level], PLAST[level], RDIST[level]
        if level < 5:
            self.moduleFeat = nn.Sequential(nn.Conv2d(FEAT_CH[level], 128, 1, 1, 0), _lrelu())
        self.conv_R = _conv_stack(r_chain(level), last_act=True)
        if level < 5:
            self.conv_dist_R = nn.Sequential(
                nn.Conv2d(32, d, (k, 1), 1, (p, 0)), nn.Conv2d(d, d, (1, k), 1, (0, p)))
        else:
            self.conv_dist_R = nn.Sequential(nn.Conv2d(32, d, k, 1, p))
        self.moduleScaleX = nn.Conv2d(d, 1, 1, 1, 0)
        self.moduleScaleY = nn.Conv2d(d, 1, 1, 1, 0)

    def forward(self, img1, img2, feat1, flow: torch.Tensor, ops: Ops, chain: bool = False) -> torch.Tensor:
        ctx = get_spatial_ctx()
        if ctx is None:
            rm_flow = flow - flow.mean(dim=(2, 3), keepdim=True)
            norm = ops.rgb_warp_norm(img1, img2, flow * self.sf).detach()
        else:
            rm_flow = flow - spatial.mean_hw(ctx, flow)
            # the difference and the squared sum in float32, rounded once, as K3's bf16 form does
            d = img1.float() - _warp(ops, img2, flow * self.sf).float()
            norm = torch.sqrt(torch.sum(d * d, dim=1, keepdim=True)).to(img1.dtype).detach()
        # the stack and the dist convs read their halo; the unfold reads fewer rows of the flow
        halo = _stencil(self.conv_R)[0] + _stencil(self.conv_dist_R)[0]
        return _rows(lambda *a: self._tail(*a, ops, chain), [norm, rm_flow, feat1, flow], halo, label="NetE-R")

    def _tail(self, norm, rm_flow, feat1, flow, ops: Ops, chain: bool) -> torch.Tensor:
        k = KLAST[self.level]
        feat_r = self.moduleFeat(feat1) if self.level < 5 else feat1
        x = self.conv_dist_R(_run_stack(self.conv_R, [norm, rm_flow, feat_r], ops, chain))
        negsq = -(x * x)
        dist = torch.exp(negsq - negsq.amax(dim=1, keepdim=True))
        divisor = 1.0 / dist.sum(dim=1, keepdim=True)
        sx = self.moduleScaleX(dist * unfold(flow[:, 0:1], k)) * divisor
        sy = self.moduleScaleY(dist * unfold(flow[:, 1:2], k)) * divisor
        return torch.cat([sx, sy], 1)


class LiteFlowNet(nn.Module):
    """LiteFlowNet version 1 or 2; ``forward`` is the eval forward, or with ``train=True`` the train forward."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.NetC = NetC()
        self.NetC_ext = nn.ModuleList([NetCExt() for _ in range(cfg.n_ext)])
        self.NetE_M = nn.ModuleList([Matching(cfg, lv) for lv in cfg.levels])
        self.NetE_S = nn.ModuleList([Subpixel(cfg, lv) for lv in cfg.levels])
        self.NetE_R = nn.ModuleList([Regularization(cfg, lv) for lv in cfg.levels])
        self.level_spans = {lv: level_spans(lv) for lv in cfg.levels}

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

    def forward(self, img1: torch.Tensor, img2: torch.Tensor, ops: Ops = KERNEL_OPS,
                train: bool = False, remat: bool = False):
        """``img1, img2 [B,3,H,W]`` in [0, 1], H and W multiples of 32.

        Eval (``train=False``): the flow ``[B,2,H',W']``, ``H' = H /
        2**(lowest_level-1)``, scaled by ``scale_factor(1)``. Train: the
        per-level ``[flow_M, flow_S, flow_R]`` lists, coarsest level first,
        unscaled, and for version 2 a last ``[flow]`` resized to ``H x W``
        (port of JAX ``forward(train=True)``). The train forward never takes
        the forward-only conv chain.

        ``remat``: each module call (NetC per frame, each NetC_ext call, each level's NetE-M, -S
        and -R) runs under ``torch.utils.checkpoint``: the backward recomputes its activations,
        so the forward's kernels launch twice per step. The gradients are the same function;
        only the memory schedule differs (JAX wraps the whole forward in ``jax.checkpoint``).
        """
        with span(MODEL):
            cfg = self.cfg
            if train and get_spatial_ctx() is not None:
                raise ValueError("the spatial context shards the eval forward only")
            chain = cfg.conv_impl == "chain" and not train
            mean = device_constant(tuple(cfg.rgb_mean), img1.dtype, img1.device)
            x1 = (img1 - mean[:3].view(1, 3, 1, 1)).contiguous()
            x2 = (img2 - mean[3:].view(1, 3, 1, 1)).contiguous()
            with span(NETC):
                feat1 = _call(self.NetC, remat, x1)
            with span(NETC):
                feat2 = _call(self.NetC, remat, x2)
            pyr1, pyr2 = [x1], [x2]
            with span(PYRAMID):
                for li in range(1, 6):
                    h, w = feat1[li].shape[2], feat1[li].shape[3]
                    pyr1.append(resize_bilinear(pyr1[-1], h, w))
                    pyr2.append(resize_bilinear(pyr2[-1], h, w))

            flow = None
            train_out: List[List[torch.Tensor]] = []
            for level in reversed(cfg.levels):
                i = level - cfg.lowest_level  # module list index
                li = level - 1                # feature / pyramid list index
                ext_span, m_span, s_span, r_span = self.level_spans[level]
                if level <= 2:
                    # reference quirk: level 2 -> ext[0], level 1 -> ext[-1]
                    ext = self.NetC_ext[0 if level == 2 else cfg.n_ext - 1]
                    with span(ext_span):
                        f1_in = _call(ext, remat, feat1[li])
                    with span(ext_span):
                        f2_in = _call(ext, remat, feat2[li])
                else:
                    f1_in, f2_in = feat1[li], feat2[li]
                with span(m_span):
                    flow_m = _call(self.NetE_M[i], remat, f1_in, f2_in, flow, ops, chain)
                with span(s_span):
                    flow_s = _call(self.NetE_S[i], remat, f1_in, f2_in, flow_m, ops, chain)
                with span(r_span):
                    flow = _call(self.NetE_R[i], remat, pyr1[li], pyr2[li], feat1[li], flow_s, ops, chain)
                train_out.append([flow_m, flow_s, flow])
            if train:
                if cfg.version == 2:
                    train_out.append([resize_bilinear(flow, img1.shape[2], img1.shape[3])])
                return train_out
            return flow * cfg.scale_factor(1)
