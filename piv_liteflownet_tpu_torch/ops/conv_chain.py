"""A whole NetE conv stack over the virtual concat of its inputs, forward only.

Port of ``piv_liteflownet_tpu/ops/pallas_conv.py``: :func:`conv_chain_plain`
is the port of its reference ``conv_chain_xla``, and :func:`conv_chain`
launches ``csrc/conv_chain.cu``, the port of the TPU kernel
``conv_chain_pallas``. NCHW here: ``parts [B,C_i,H,W]``, ``weights[l]``
``[Cout_l, Cin_l, k, k]`` (torch's layout; ``Cin_0 = sum C_i``),
``biases[l] [Cout_l]`` -> ``[B,Cout_last,H,W]``. Every conv is SAME and
stride 1 and is followed by LeakyReLU(0.1), except the last one when
``last_linear`` is set.

On CUDA tensors the whole stack is one cooperative launch that runs the
layers in turn (see the note in the source): layers of more than 8 output
channels on the tensor cores at float32 accuracy (3xTF32: every operand split
as :func:`tf32_split` does, three TF32 products per multiply-add), the rest
with float32 FMAs. :func:`layer_plan` is the per-layer rule (path, channel
tile, shared memory, packed-weight layout) that the wrapper passes to the
kernel. The kernel has no backward, and the wrapper says so loudly: it raises
whenever autograd would need a gradient, on both paths, rather than return a
result cut from the graph.

bfloat16 operands (all of them) take the kernel's bf16 form, C entry point
``pivk_conv_chain_bf16``, and the output is bf16. It computes what the TPU
kernel computes in bf16: every tap, channel and part summed in float32, the
bias added and the LeakyReLU applied in float32, and one rounding to bf16 per
layer; :func:`conv_chain_plain` follows the same rule. Its tensor-core layers
run ``wgmma`` on bf16 operands (one product per multiply-add), fed by TMA
loads of the NHWC scratch through a tensor map per layer (:func:`tma_box`)
and by bulk copies of weights packed in the image the kernel's B descriptor
reads (:func:`_pack_layer`, :func:`b_image_offset`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from piv_liteflownet_tpu_torch import kernels
from piv_liteflownet_tpu_torch.ops.nn import leaky_relu

MAX_PARTS = 3
MAX_LAYERS = 8
KERNEL_SIZES = (1, 3, 5, 7)
#: Shared memory a block may take on an H100 (227 KB), less 1 KB for static arrays.
SMEM_BUDGET = 232448 - 1024
#: Channel tiles of the tensor-core path, widest first (a thread holds a tile's sums twice, as
#: the running total and a step's fresh sum: 2 x 64 registers at 64); layers of at most
#: ``FFMA_MAX_COUT`` output channels take the FFMA path.
MMA_WIDTHS = (64, 32)
FFMA_MAX_COUT = 8
MMA_TILE = (8, 32)     # output rows x columns of a tensor-core tile
MMA_CHUNK = 16         # input channels per staged chunk (K is padded to it)
MMA_PIXEL_WORDS = 20   # staged words per pixel of a chunk, and per weight row (float32 form)
#: Channel tiles of the bf16 form's tensor-core path (the N of its ``wgmma``).
MMA_WIDTHS_BF16 = (128, 96, 64, 32)
TC_COLS = 64           # bf16 form: staged columns of an input tile (the pixels of an m64 block)
TC_STAGES = (3, 6)     # bf16 form: stages of the input ring and of the weight ring
FFMA_TILE = (32, 32)
FFMA_CHUNK = 8

#: Kernel launches made by :func:`conv_chain` (plain-path calls do not count): the float32 form.
launches = 0
#: The same for the bf16 form.
bf16_launches = 0

# Packed weights per stack, keyed by the ids of its weight and bias tensors; an
# entry holds weak references to them and is valid while they live, sit at the
# same address and have not been modified in place since it was packed.
_packs: Dict[Tuple[int, ...], tuple] = {}


def conv_chain_plain(parts: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor], last_linear: bool = True) -> torch.Tensor:
    """The chain with ``F.conv2d``; the first conv is a sum of per-part convs (port of ``conv_chain_xla``).

    In bfloat16 it follows the TPU kernel, not ``conv_chain_xla`` in bf16: every conv in float32
    on the widened values, the per-part convs of the first summed, the bias and the activation
    in float32, and one rounding to bf16 per layer.
    """
    bf16 = parts[0].dtype == torch.bfloat16
    if bf16:
        parts, weights, biases = ([t.float() for t in ts] for ts in (parts, weights, biases))

    def rounded(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).float() if bf16 else x

    w0 = weights[0]
    acc = None
    off = 0
    for p in parts:
        c = p.shape[1]
        y = F.conv2d(p, w0[:, off:off + c], None, 1, (w0.shape[2] // 2, w0.shape[3] // 2))
        acc = y if acc is None else acc + y
        off += c
    x = acc + biases[0].view(1, -1, 1, 1)
    n = len(weights)
    if n > 1 or not last_linear:
        x = leaky_relu(x)
    x = rounded(x)
    for i in range(1, n):
        w = weights[i]
        x = F.conv2d(x, w, biases[i], 1, (w.shape[2] // 2, w.shape[3] // 2))
        if i < n - 1 or not last_linear:
            x = leaky_relu(x)
        x = rounded(x)
    return x.to(torch.bfloat16) if bf16 else x


def _check(parts, weights, biases) -> None:
    if not 1 <= len(parts) <= MAX_PARTS or not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"conv_chain: takes 1-{MAX_PARTS} parts and 1-{MAX_LAYERS} convs, "
                         f"got {len(parts)} and {len(weights)}")
    if len(biases) != len(weights):
        raise ValueError(f"conv_chain: {len(weights)} weights but {len(biases)} biases")
    b, _, h, w = parts[0].shape
    if any(p.dim() != 4 or (p.shape[0], p.shape[2], p.shape[3]) != (b, h, w) for p in parts):
        raise ValueError(f"conv_chain: parts must be [B,C_i,H,W] of one B, H and W, got "
                         f"{[tuple(p.shape) for p in parts]}")
    cin = sum(p.shape[1] for p in parts)
    for i, (wt, bs) in enumerate(zip(weights, biases)):
        cout, wcin, kh, kw = wt.shape
        if wcin != cin or kh != kw or kh not in KERNEL_SIZES or tuple(bs.shape) != (cout,):
            raise ValueError(f"conv_chain: conv {i} has weight {tuple(wt.shape)} and bias "
                             f"{tuple(bs.shape)}; expected [Cout,{cin},k,k], k in "
                             f"{KERNEL_SIZES}, and [Cout]")
        cin = cout


def conv_chain(parts: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor], last_linear: bool = True) -> torch.Tensor:
    """The chain; the kernel on CUDA, :func:`conv_chain_plain` on the CPU. Forward only.

    Operands are all float32 or all bfloat16 (anything else raises ``TypeError``); the output
    has their dtype. Raises ``RuntimeError`` when grad mode is on and an operand requires grad.
    """
    _check(parts, weights, biases)
    operands = [*parts, *weights, *biases]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError(
            "conv_chain is forward only and has no gradient: call it under torch.no_grad(), "
            "or use the model's conv_impl='cudnn' to train")
    parts = [p.contiguous() for p in parts]
    if not kernels.on_cuda("conv_chain", *parts, *(t.contiguous() for t in (*weights, *biases))):
        return conv_chain_plain(parts, weights, biases, last_linear)
    global launches, bf16_launches
    b, _, h, w = parts[0].shape
    out = torch.empty((b, weights[-1].shape[0], h, w), device=parts[0].device, dtype=parts[0].dtype)
    if out.numel() == 0:
        return out
    _launch(parts, weights, biases, last_linear, out)
    if out.dtype == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return out


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` float32 tensors with ``x ~ hi + lo``, each a TF32 value (low 13 mantissa bits 0).

    ``hi`` rounds ``x`` to TF32 to nearest, ties away from zero (PTX ``cvt.rna.tf32.f32``), and
    ``lo`` rounds ``x - hi`` (exact in float32) the same way: ``|x - hi - lo| <= 2^-22 |x|``.
    Rounding adds half a TF32 unit to the magnitude bits and clears the 13 below it.
    """
    def rna(v: torch.Tensor) -> torch.Tensor:
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """How the kernel runs one conv of a stack, and where its packed weights lie."""

    k: int
    cin: int
    cout: int
    bn: int    # output channels per tile on the tensor-core path; 0: the FFMA path
    woff: int  # offset of the layer's packed weights in the stack's buffer, in elements
    boff: int  # offset of its bias [cout]
    dtype: torch.dtype = torch.float32

    @property
    def path(self) -> str:
        return "mma" if self.bn else "ffma"

    @property
    def cin_pad(self) -> int:
        """K rows per tap of the packed weights: cin rounded up to a chunk (tensor-core path)."""
        return -(-self.cin // MMA_CHUNK) * MMA_CHUNK if self.bn else self.cin

    @property
    def cout_pad(self) -> int:
        return -(-self.cout // self.bn) * self.bn if self.bn else self.cout

    @property
    def weight_elems(self) -> int:
        """Packed weight elements: on the tensor-core path hi and lo in float32, the bf16 weights
        in bf16; the weights as they are on the FFMA path."""
        split = 2 if self.bn and self.dtype == torch.float32 else 1
        return split * self.cin_pad * self.k * self.k * self.cout_pad

    @property
    def smem(self) -> int:
        """Dynamic shared memory of the layer's block, in bytes (as the kernel computes it)."""
        return _smem(self.k, self.bn, self.cout, self.dtype)


def tile_rows(bn: int) -> int:
    """Output rows of a bf16 tensor-core tile at channel tile ``bn``: two consumer warpgroups, each
    with half the rows as m64 blocks of ``bn / 2`` float32 sums a thread, at most 128."""
    return 4 if bn >= 96 else 512 // bn


def tile_cols(k: int) -> int:
    """Valid output columns of a bf16 tensor-core tile: the 64 staged columns less the halo."""
    return TC_COLS - (k - 1)


def _smem(k: int, bn: int, cout: int, dtype: torch.dtype = torch.float32) -> int:
    if bn:
        th, tw = MMA_TILE
        if dtype == torch.bfloat16:
            # the input ring: two 8-channel planes of (rows + k - 1) x 64 pixels of 16 bytes and 8
            # spare pixels; the weight ring: (chunk, ky) slices of k x bn x 16 bf16; an epilogue tile
            # [64][bn + 8] bf16 per consumer warpgroup; 1024 bytes to align the rings
            plane = ((tile_rows(bn) + k - 1) * TC_COLS + 8) * 16
            na, nb = TC_STAGES
            return 1024 + na * 2 * plane + nb * k * bn * MMA_CHUNK * 2 + 2 * TC_COLS * (bn + 8) * 2
        # the input chunk with its halo: two stages and a lo half; two of [kx][hi|lo][bn][ci]
        a = (th + k - 1) * (tw + k - 1) * MMA_PIXEL_WORDS
        return 4 * (3 * a + 2 * k * 2 * bn * MMA_PIXEL_WORDS)
    th, tw = FFMA_TILE  # the input tile with its halo, and the weights [ci][k][k][rc], in float32
    rc = 2 if cout <= 2 else 4 if cout <= 4 else 8
    return 4 * (FFMA_CHUNK * (th + k - 1) * ((tw + k - 1 + 3) & ~3) + FFMA_CHUNK * k * k * rc)


def layer_plan(shapes: Sequence[Tuple[int, int, int]],
               dtype: torch.dtype = torch.float32) -> Tuple[LayerPlan, ...]:
    """The kernel's plan of a stack of convs given as ``(k, cin, cout)``, in the form of ``dtype``.

    A layer of more than ``FFMA_MAX_COUT`` output channels takes the tensor-core path; the others
    take the FFMA path. Its channel tile in float32 is the widest of ``MMA_WIDTHS`` that is no
    wider than its channels rounded up to 32 and whose shared memory fits ``SMEM_BUDGET``; in
    bf16, of the tiles of ``MMA_WIDTHS_BF16`` that fit, the one that makes the fewest channel tiles
    (each stages and reads the input tile again), and of those the one that computes the fewest
    channels (``ceil(cout / bn) * bn``). Each layer's packed weights start at a
    multiple of 16 bytes (4 floats, 8 bf16: 16-byte copies), then its bias.
    """
    align = 16 * 8 // torch.finfo(dtype).bits
    plans, off = [], 0
    for k, cin, cout in shapes:
        bn = 0
        if cout > FFMA_MAX_COUT and dtype == torch.bfloat16:
            fits = [b for b in MMA_WIDTHS_BF16 if _smem(k, b, cout, dtype) <= SMEM_BUDGET]
            bn = min(fits, key=lambda b: (-(-cout // b), -(-cout // b) * b))
        elif cout > FFMA_MAX_COUT:
            bn = next(b for b in MMA_WIDTHS
                      if b <= -(-cout // 32) * 32 and _smem(k, b, cout, dtype) <= SMEM_BUDGET)
        plan = LayerPlan(k, cin, cout, bn, off, 0, dtype)
        plan = dataclasses.replace(plan, boff=off + plan.weight_elems)
        off = -(-(plan.boff + cout) // align) * align
        plans.append(plan)
    return tuple(plans)



def _pack_layer(plan: LayerPlan, wt: torch.Tensor) -> torch.Tensor:
    """One conv's weight ``[Cout,Cin,k,k]`` in the kernel's layout (see ``csrc/conv_chain.cu``)."""
    if not plan.bn:
        return wt.permute(1, 2, 3, 0).reshape(-1)  # [cin][ky][kx][cout]
    k, bn, ck = plan.k, plan.bn, MMA_CHUNK
    padded = wt.new_zeros((plan.cout_pad, plan.cin_pad, k, k))
    padded[:plan.cout, :plan.cin] = wt
    if wt.dtype == torch.bfloat16:  # no split: [cout/bn][chunk][ky][kx] B images, see b_image_offset
        padded = padded.view(plan.cout_pad // bn, bn // 8, 8, plan.cin_pad // ck, 2, 8, k, k)
        return padded.permute(0, 3, 6, 7, 1, 4, 2, 5).reshape(-1)
    hl = torch.stack(tf32_split(padded))  # [hl][cout][cin][ky][kx]
    hl = hl.view(2, plan.cout_pad // bn, bn, plan.cin_pad // ck, ck, k, k)
    return hl.permute(1, 3, 5, 6, 0, 2, 4).reshape(-1)  # [cout/bn][chunk][ky][kx][hl][bn][ci]


def b_image_offset(n: int, ci: int) -> int:
    """Where the bf16 form's B descriptor reads output channel ``n`` (of the tile) and input channel
    ``ci`` (of the chunk) in a tap's image, in elements: core matrices of 8 output x 8 input
    channels (128 bytes, rows of 16 bytes), the second 8 input channels 128 bytes on (LBO), the
    next 8 output channels 256 bytes on (SBO). No swizzle: each core matrix is 128 contiguous
    bytes. A (chunk, ky) stage holds the k taps' images, ``bn * 16`` elements apart."""
    return (n // 8) * 128 + (ci // 8) * 64 + (n % 8) * 8 + ci % 8


@dataclasses.dataclass(frozen=True)
class TmaBox:
    """The tensor map the bf16 form encodes for a tensor-core layer's input, the NHWC scratch, as
    ``cuTensorMapEncodeTiled`` takes it (innermost dimension first)."""

    dims: Tuple[int, int, int, int]     # (C, W, H, B) elements
    strides: Tuple[int, int, int]       # bytes between consecutive W, H and B indices
    box: Tuple[int, int, int, int]      # elements of one load: 8 channels x 64 columns x rows x 1


def tma_box(plan: LayerPlan, b: int, h: int, w: int) -> TmaBox:
    """The tensor map of ``plan``'s input (a bf16 tensor-core layer) for a ``[b, cin, h, w]`` map,
    as ``csrc/conv_chain.cu:encode_input_map`` encodes it: pixels ``cin`` rounded up to 8 bf16
    apart; a box is one 8-channel plane of the tile's ``tile_rows(bn) + k - 1`` rows by 64 columns
    (the channels past ``cin`` and the pixels off the map read as zeros)."""
    px = -(-plan.cin // 8) * 8 * 2
    return TmaBox((plan.cin, w, h, b), (px, px * w, px * w * h),
                  (8, TC_COLS, tile_rows(plan.bn) + plan.k - 1, 1))


def _packed(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, tuple]:
    """The stack's weights and biases in one buffer laid out by :func:`layer_plan` in their dtype,
    and the plan; cached per stack and dtype."""
    tensors = [*weights, *biases]
    key = tuple(id(t) for t in tensors)
    state = [(t.data_ptr(), t._version, t.dtype) for t in tensors]
    hit = _packs.get(key)
    if hit is not None:
        refs, was, packed = hit
        if all(r() is t for r, t in zip(refs, tensors)) and was == state:
            return packed
    plans = layer_plan([(wt.shape[2], wt.shape[1], wt.shape[0]) for wt in weights], weights[0].dtype)
    with torch.no_grad():
        buf = weights[0].new_zeros(plans[-1].boff + plans[-1].cout)
        for plan, wt, bs in zip(plans, weights, biases):
            buf[plan.woff:plan.woff + plan.weight_elems] = _pack_layer(plan, wt)
            buf[plan.boff:plan.boff + plan.cout] = bs
    for k in [k for k, (refs, _, _) in _packs.items() if any(r() is None for r in refs)]:
        del _packs[k]
    _packs[key] = ([weakref.ref(t) for t in tensors], state, (buf, plans))
    return buf, plans


def _launch(parts: List[torch.Tensor], weights: Sequence[torch.Tensor],
            biases: Sequence[torch.Tensor], last_linear: bool, out: torch.Tensor) -> None:
    """The kernel call itself (a test can substitute a fake); it overwrites ``out``."""
    b, _, h, w = parts[0].shape
    packed, plans = _packed(weights, biases)
    # NHWC intermediates, pixels (cout rounded up to 16 bytes) elements apart; the bf16 form also
    # repacks the parts into the second buffer, which 16 bytes for its grid barrier's counter follow
    v = 16 // out.element_size()
    bf16 = out.dtype == torch.bfloat16
    widths = [p.cout for p in plans[:-1]] + ([plans[0].cin] if bf16 else [])
    mid = max((-(-c // v) * v for c in widths), default=v)
    n = b * mid * h * w
    scratch = torch.empty(2 * n + (v if bf16 else 0), device=out.device, dtype=out.dtype)
    part_ptrs = (ctypes.c_void_p * len(parts))(*(p.data_ptr() for p in parts))
    part_c = (ctypes.c_int * len(parts))(*(p.shape[1] for p in parts))
    c_plan = (ctypes.c_int * (5 * len(plans)))(
        *(v for p in plans for v in (p.k, p.cout, p.bn, p.woff, p.boff)))
    kernels.launch(kernels.entry("conv_chain", out.dtype), "conv_chain", out.device,
                   ctypes.addressof(part_ptrs), ctypes.addressof(part_c), len(parts),
                   ctypes.addressof(c_plan), len(plans), packed.data_ptr(),
                   scratch.data_ptr(), scratch[n:].data_ptr(), out.data_ptr(), b, h, w,
                   int(last_linear))
