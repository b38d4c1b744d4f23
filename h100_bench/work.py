"""The work of one call of the model, counted from its shapes: the convs' operations, and the
bytes and operations of each op that the program's own kernels carry. A frozen yardstick:
the work is the op's, whatever kernel computes it.

- A conv counts ``2 * B * Cout * Cin/groups * kh * kw * Hout * Wout`` operations; a
  transposed one ``2 * B * C_in * (Cout/groups) * kh * kw * Hin * Win``, as torch's
  ``FlopCounterMode`` counts them. In training the backward adds the weight gradient and,
  for every conv whose input needs a gradient (all but the first conv on the frames), the
  input gradient, each as many operations as the forward. Recompute is not counted.
- An op's bytes are each input read once and each output written once, in the model's
  dtype; its bound is the larger of the bytes over the device's bandwidth and the
  operations over the configuration's peak.

The model's layout (channels per level, the stacks, which levels warp with stride 2) is that
of PIV-LiteFlowNet-en and -2-en, as ``reference/model.py`` computes it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

HBM_BYTES_S = 3.35e12  # H100 SXM
KLAST = [0, 7, 7, 5, 5, 3, 3]
RDIST = [0, 49, 49, 25, 25, 9, 9]
FEAT_CH = [0, 32, 32, 64, 96, 128, 192]
EXT_CH = 64
CHAIN_MIN = 32  # a NetE stack runs as one conv chain on a level at least this size
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


@dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    kh: int
    kw: int
    b: int
    h_in: int
    w_in: int
    stride: int = 1
    transposed_groups: int = 0  # a depthwise deconv of this many channels
    dgrad: bool = True

    @property
    def out_hw(self) -> Tuple[int, int]:
        if self.transposed_groups:
            return self.h_in * 2, self.w_in * 2
        return -(-self.h_in // self.stride), -(-self.w_in // self.stride)

    @property
    def flops(self) -> int:
        if self.transposed_groups:
            return 2 * self.b * self.cin * 1 * self.kh * self.kw * self.h_in * self.w_in
        ho, wo = self.out_hw
        return 2 * self.b * self.cout * self.cin * self.kh * self.kw * ho * wo


@dataclass(frozen=True)
class Op:
    """One launch-level op of the model: its inputs' and outputs' shapes and its operations."""

    name: str
    inputs: Tuple[Tuple[int, ...], ...]
    outputs: Tuple[Tuple[int, ...], ...]
    flops: int
    weights: int = 0  # parameter elements it reads (the conv chain)

    def bytes(self, elem: int) -> int:
        n = sum(_numel(s) for s in self.inputs + self.outputs) + self.weights
        return n * elem

    def bound_s(self, elem: int, peak_flops: float) -> float:
        return max(self.bytes(elem) / HBM_BYTES_S, self.flops / peak_flops)


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def m_chain(version: int) -> List[Tuple[int, int]]:
    if version == 1:
        return [(49, 128), (128, 64), (64, 32), (32, 2)]
    return [(49, 128), (128, 128), (128, 96), (96, 64), (64, 32), (32, 2)]


def s_chain(level: int, version: int) -> List[Tuple[int, int]]:
    c = EXT_CH if level <= 2 else FEAT_CH[level]
    return [(2 * c + 2, 128)] + m_chain(version)[1:]


def r_chain(level: int) -> List[Tuple[int, int]]:
    feat = 128 if level < 5 else FEAT_CH[level]
    return [(3 + feat, 128), (128, 128), (128, 64), (64, 64), (64, 32), (32, 32)]


def levels(model: dict) -> List[int]:
    return list(range(int(model["lowest_level"]), 7))


def convs(model: dict, b: int, h: int, w: int) -> List[Conv]:
    """Every conv and deconv of one forward on ``b`` pairs of ``h x w`` (multiples of 32)."""
    v = int(model["version"])
    out: List[Conv] = []
    netc = [("conv1.0", 3, 32, 7, 1), ("conv2.0", 32, 32, 3, 2), ("conv2.2", 32, 32, 3, 1),
            ("conv2.4", 32, 32, 3, 1), ("conv3.0", 32, 64, 3, 2), ("conv3.2", 64, 64, 3, 1),
            ("conv4.0", 64, 96, 3, 2), ("conv4.2", 96, 96, 3, 1), ("conv5.0", 96, 128, 3, 2),
            ("conv6.0", 128, 192, 3, 2)]
    for _frame in range(2):
        hh, ww = h, w
        for name, cin, cout, k, s in netc:
            c = Conv("NetC." + name, cin, cout, k, k, b, hh, ww, s, dgrad=name != "conv1.0")
            out.append(c)
            hh, ww = c.out_hw
    lv = levels(model)
    n_ext = max(0, 3 - lv[0])
    size = {lvl: (h >> (lvl - 1), w >> (lvl - 1)) for lvl in range(1, 7)}
    for level in reversed(lv):
        i = level - lv[0]
        hl, wl = size[level]
        if level <= 2:
            j = 0 if level == 2 else n_ext - 1
            out += [Conv(f"NetC_ext.{j}.conv_ext.0", FEAT_CH[level], EXT_CH, 1, 1, b, hl, wl)] * 2
        if level != 6:
            out.append(Conv(f"NetE_M.{i}.upConv_M", 2, 2, 4, 4, b, *size[level + 1], transposed_groups=2))
        if level < 4:
            out.append(Conv(f"NetE_M.{i}.upCorr_M", 49, 49, 4, 4, b, hl // 2, wl // 2, transposed_groups=49))
        for tag, chain in (("NetE_M.%d.conv_M" % i, m_chain(v)), ("NetE_S.%d.conv_S" % i, s_chain(level, v))):
            for ci, (cin, cout) in enumerate(chain):
                k = KLAST[level] if ci == len(chain) - 1 else 3
                out.append(Conv(f"{tag}.{2 * ci}", cin, cout, k, k, b, hl, wl))
        pfx = f"NetE_R.{i}"
        if level < 5:
            out.append(Conv(pfx + ".moduleFeat.0", FEAT_CH[level], 128, 1, 1, b, hl, wl))
        for ci, (cin, cout) in enumerate(r_chain(level)):
            out.append(Conv(f"{pfx}.conv_R.{2 * ci}", cin, cout, 3, 3, b, hl, wl))
        k, d = KLAST[level], RDIST[level]
        if level < 5:
            out += [Conv(pfx + ".conv_dist_R.0", 32, d, k, 1, b, hl, wl),
                    Conv(pfx + ".conv_dist_R.1", d, d, 1, k, b, hl, wl)]
        else:
            out.append(Conv(pfx + ".conv_dist_R.0", 32, d, k, k, b, hl, wl))
        out += [Conv(pfx + ".moduleScaleX", d, 1, 1, 1, b, hl, wl), Conv(pfx + ".moduleScaleY", d, 1, 1, 1, b, hl, wl)]
    return out


def conv_flops(model: dict, b: int, h: int, w: int, train: bool = False) -> int:
    """The convs' operations of one forward (``train``: and its backward)."""
    total = 0
    for c in convs(model, b, h, w):
        total += c.flops * ((2 + c.dgrad) if train else 1)
    return total


def _chain(name: str, parts: Sequence[int], layers: List[Tuple[int, int, int]], b: int, hl: int, wl: int) -> Op:
    flops = sum(2 * cin * cout * k * k * b * hl * wl for cin, cout, k in layers)
    weights = sum(cin * cout * k * k + cout for cin, cout, k in layers)
    return Op(name, tuple((b, c, hl, wl) for c in parts), ((b, layers[-1][1], hl, wl),), flops, weights)


def port_ops(model: dict, b: int, h: int, w: int, chain: bool = False, train: bool = False) -> List[Op]:
    """The ops of one call that the program's kernels carry: the cost volume, the feature
    warps, the rgb warp with its norm, with ``chain`` (eval only) each NetE stack of a level of
    at least ``CHAIN_MIN`` square, and with ``train`` the gradients of the cost volume and the
    warps."""
    v = int(model["version"])
    ops: List[Op] = []
    lv = levels(model)
    for level in reversed(lv):
        c = EXT_CH if level <= 2 else FEAT_CH[level]
        hl, wl = h >> (level - 1), w >> (level - 1)
        feat = (b, c, hl, wl)

        def warp(stride: int):
            ho, wo = -(-hl // stride), -(-wl // stride)
            return Op("backwarp", (feat, (b, 2, ho, wo)), ((b, c, ho, wo),), 8 * b * c * ho * wo)

        if level >= 4:
            if level != 6:
                ops.append(warp(1))
            ops.append(Op("corr49", (feat, feat), ((b, 49, hl, wl),), 2 * 49 * b * c * hl * wl))
        else:
            ops.append(warp(2))
            half = (b, c, hl // 2, wl // 2)
            ops.append(Op("corr49", (half, half), ((b, 49, hl // 2, wl // 2),), 2 * 49 * b * c * (hl // 2) * (wl // 2)))
        use_chain = chain and not train and hl >= CHAIN_MIN and wl >= CHAIN_MIN
        mc = m_chain(v)
        if use_chain:
            ops.append(_chain("conv_chain", [49], [(ci, co, KLAST[level] if j == len(mc) - 1 else 3)
                                                   for j, (ci, co) in enumerate(mc)], b, hl, wl))
        ops.append(warp(1))
        if use_chain:
            sc = s_chain(level, v)
            ops.append(_chain("conv_chain", [c, c, 2], [(ci, co, KLAST[level] if j == len(sc) - 1 else 3)
                                                        for j, (ci, co) in enumerate(sc)], b, hl, wl))
        img = (b, 3, hl, wl)
        ops.append(Op("rgb_warp_norm", (img, img, (b, 2, hl, wl)), ((b, 1, hl, wl),), 20 * b * hl * wl))
        if use_chain:
            rc = r_chain(level)
            ops.append(_chain("conv_chain", [1, 2, rc[0][0] - 3], [(ci, co, 3) for ci, co in rc], b, hl, wl))
    if train:
        for op in list(ops):
            if op.name == "backwarp":
                img, fl = op.inputs
                ops.append(Op("backwarp_bwd", (img, fl, op.outputs[0]), (img, fl), 2 * op.flops))
            elif op.name == "corr49":
                f = op.inputs[0]
                ops.append(Op("corr49_bwd", (f, f, op.outputs[0]), (f, f), 2 * op.flops))
    return ops


def op_counts(ops: List[Op]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for op in ops:
        out[op.name] = out.get(op.name, 0) + 1
    return out
