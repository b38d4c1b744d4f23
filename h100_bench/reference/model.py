"""PIV-LiteFlowNet-en (version 1) and PIV-LiteFlowNet2-en (version 2), eval and train forward,
as plain functions of a state dict.

Written from the published network (Hui et al. 2018, LiteFlowNet; Cai et al. 2019 and
Silitonga 2020 for the PIV variants, abrosua/piv_liteflownet-pytorch ``src/models.py``),
with the state-dict names of that code: a feature pyramid NetC, then for each level from
the coarsest a descriptor-matching NetE-M (a 7x7 cost volume on the warped features, a conv
stack), a sub-pixel NetE-S and a flow-regularisation NetE-R. Version 2 has 6-conv M and S
stacks. Kept as the published code has them: level 2 takes ``NetC_ext[0]`` and level 1
``NetC_ext[-1]``; below level 4 NetE-M warps and correlates the even phase of the maps and
upsamples the cost volume with ``upCorr_M``; the occlusion norm carries no gradient.

``quant``, where given, is applied to the input and the weight of every conv and deconv:
the reference in a lower precision, for the benchmark's control.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from h100_bench.reference import ops

Params = Dict[str, torch.Tensor]
KLAST = [0, 7, 7, 5, 5, 3, 3]   # last conv of M and S, the unfold of R, per level 1..6
RDIST = [0, 49, 49, 25, 25, 9, 9]


class Net:
    """One model: its state dict, its configuration file's ``model`` entry and a quantizer."""

    def __init__(self, params: Params, model: dict, quant: Optional[Callable] = None):
        self.p = params
        self.version = int(model["version"])
        self.scale = float(model["starting_scale"])
        self.lowest = int(model["lowest_level"])
        self.mean = torch.tensor(model["rgb_mean"], dtype=torch.float32)
        self.q = quant or (lambda t: t)

    def conv(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        w = self.p[name + ".weight"]
        pad = ((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2)
        return F.conv2d(self.q(x), self.q(w), self.p.get(name + ".bias"), stride, pad)

    def deconv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return ops.deconv4x2(self.q(x), self.q(self.p[name + ".weight"]))

    def stack(self, x: torch.Tensor, prefix: str, n: int, last_act: bool = False) -> torch.Tensor:
        for i in range(n):
            x = self.conv(x, f"{prefix}.{2 * i}")
            if i < n - 1 or last_act:
                x = ops.leaky_relu(x)
        return x

    def sf(self, level: int) -> float:
        return self.scale / 2.0 ** level

    def netc(self, x: torch.Tensor) -> List[torch.Tensor]:
        c = lambda t, name, s=1: ops.leaky_relu(self.conv(t, "NetC." + name, s))  # noqa: E731
        f1 = c(x, "conv1.0")
        f2 = c(c(c(f1, "conv2.0", 2), "conv2.2"), "conv2.4")
        f3 = c(c(f2, "conv3.0", 2), "conv3.2")
        f4 = c(c(f3, "conv4.0", 2), "conv4.2")
        f5 = c(f4, "conv5.0", 2)
        f6 = c(f5, "conv6.0", 2)
        return [f1, f2, f3, f4, f5, f6]

    def matching(self, i: int, level: int, f1, f2, flow):
        pfx = f"NetE_M.{i}"
        n = 4 if self.version == 1 else 6
        if flow is not None:
            flow = self.deconv(flow, pfx + ".upConv_M")
        if level >= 4:
            f2w = f2 if flow is None else ops.backwarp(f2, flow * self.sf(level))
            x = self.stack(ops.leaky_relu(ops.corr49(self.q(f1), self.q(f2w))), pfx + ".conv_M", n)
        else:
            f1s = f1[:, :, ::2, ::2]
            f2s = f2[:, :, ::2, ::2] if flow is None else ops.backwarp(f2, flow[:, :, ::2, ::2] * self.sf(level), 2)
            corr = self.deconv(ops.leaky_relu(ops.corr49(self.q(f1s), self.q(f2s))), pfx + ".upCorr_M")
            x = self.stack(corr, pfx + ".conv_M", n)
        return x if flow is None else x + flow

    def subpixel(self, i: int, level: int, f1, f2, flow):
        n = 4 if self.version == 1 else 6
        f2w = ops.backwarp(f2, flow * self.sf(level))
        return self.stack(torch.cat([f1, f2w, flow], 1), f"NetE_S.{i}.conv_S", n) + flow

    def regularization(self, i: int, level: int, img1, img2, feat1, flow):
        pfx = f"NetE_R.{i}"
        k = KLAST[level]
        rm_flow = flow - flow.mean(dim=(2, 3), keepdim=True)
        norm = ops.rgb_warp_norm(img1, img2, flow * self.sf(level))
        feat = ops.leaky_relu(self.conv(feat1, pfx + ".moduleFeat.0")) if level < 5 else feat1
        x = self.stack(torch.cat([norm, rm_flow, feat], 1), pfx + ".conv_R", 6, last_act=True)
        x = self.conv(x, pfx + ".conv_dist_R.0")
        if level < 5:
            x = self.conv(x, pfx + ".conv_dist_R.1")
        negsq = -(x * x)
        dist = torch.exp(negsq - negsq.amax(dim=1, keepdim=True))
        divisor = 1.0 / dist.sum(dim=1, keepdim=True)
        sx = self.conv(dist * ops.unfold(flow[:, 0:1], k), pfx + ".moduleScaleX") * divisor
        sy = self.conv(dist * ops.unfold(flow[:, 1:2], k), pfx + ".moduleScaleY") * divisor
        return torch.cat([sx, sy], 1)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor, train: bool = False):
        """``img1, img2 [B,3,H,W]`` in [0, 1], H and W multiples of 32. Eval: the flow at the
        lowest level's size, scaled by ``starting_scale / 2``. Train: per level from the
        coarsest ``[flow_M, flow_S, flow_R]``, unscaled; version 2 adds ``[flow]`` resized to
        ``H x W``."""
        mean = self.mean.to(img1.device)
        x1 = img1 - mean[:3].view(1, 3, 1, 1)
        x2 = img2 - mean[3:].view(1, 3, 1, 1)
        feat1, feat2 = self.netc(x1), self.netc(x2)
        pyr1, pyr2 = [x1], [x2]
        for li in range(1, 6):
            h, w = feat1[li].shape[2:]
            pyr1.append(ops.resize(pyr1[-1], h, w))
            pyr2.append(ops.resize(pyr2[-1], h, w))
        n_ext = max(0, 3 - self.lowest)
        flow, outs = None, []
        for level in range(6, self.lowest - 1, -1):
            i, li = level - self.lowest, level - 1
            f1, f2 = feat1[li], feat2[li]
            if level <= 2:
                ext = "NetC_ext.%d.conv_ext.0" % (0 if level == 2 else n_ext - 1)
                f1 = ops.leaky_relu(self.conv(f1, ext))
                f2 = ops.leaky_relu(self.conv(f2, ext))
            flow_m = self.matching(i, level, f1, f2, flow)
            flow_s = self.subpixel(i, level, f1, f2, flow_m)
            flow = self.regularization(i, level, pyr1[li], pyr2[li], feat1[li], flow_s)
            outs.append([flow_m, flow_s, flow])
        if not train:
            return flow * self.sf(1)
        if self.version == 2:
            outs.append([ops.resize(flow, img1.shape[2], img1.shape[3])])
        return outs


def estimate(net: Net, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """The flow ``[B,H,W,2]`` of frames ``[B,H,W,3]`` in [0, 1]: resized to the next multiple
    of 32, the eval forward, resized back with u scaled by ``W / W32`` and v by ``H / H32``."""
    x1 = img1.permute(0, 3, 1, 2).float()
    x2 = img2.permute(0, 3, 1, 2).float()
    h, w = x1.shape[2:]
    ah, aw = -(-h // 32) * 32, -(-w // 32) * 32
    flow = net.forward(ops.resize(x1, ah, aw), ops.resize(x2, ah, aw))
    flow = ops.resize(flow, h, w)
    scale = torch.tensor([w / aw, h / ah], dtype=flow.dtype, device=flow.device).view(1, 2, 1, 1)
    return (flow * scale).permute(0, 2, 3, 1)
