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
layers in turn in exact float32 (see the note in the source). The kernel has
no backward, and the wrapper says so loudly: it raises whenever autograd
would need a gradient, on both paths, rather than return a result cut from
the graph.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from piv_liteflownet_tpu_torch import kernels
from piv_liteflownet_tpu_torch.ops.nn import leaky_relu

MAX_PARTS = 3
MAX_LAYERS = 8
KERNEL_SIZES = (1, 3, 5, 7)

#: Kernel launches made by :func:`conv_chain` (plain-path calls do not count).
launches = 0

# Packed weights per stack, keyed by the ids of its weight and bias tensors; an
# entry holds weak references to them and is valid while they live, sit at the
# same address and have not been modified in place since it was packed.
_packs: Dict[Tuple[int, ...], tuple] = {}


def conv_chain_plain(parts: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor], last_linear: bool = True) -> torch.Tensor:
    """The chain with ``F.conv2d``; the first conv is a sum of per-part convs (port of ``conv_chain_xla``)."""
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
    for i in range(1, n):
        w = weights[i]
        x = F.conv2d(x, w, biases[i], 1, (w.shape[2] // 2, w.shape[3] // 2))
        if i < n - 1 or not last_linear:
            x = leaky_relu(x)
    return x


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

    Raises ``RuntimeError`` when grad mode is on and an operand requires grad.
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
    global launches
    b, _, h, w = parts[0].shape
    out = torch.empty((b, weights[-1].shape[0], h, w), device=parts[0].device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    _launch(parts, weights, biases, last_linear, out)
    launches += 1
    return out


def _packed(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per conv, the weight as ``[Cin][k][k][Cout]`` then the bias, in one buffer; cached per stack."""
    tensors = [*weights, *biases]
    key = tuple(id(t) for t in tensors)
    state = [(t.data_ptr(), t._version) for t in tensors]
    hit = _packs.get(key)
    if hit is not None:
        refs, was, packed = hit
        if all(r() is t for r, t in zip(refs, tensors)) and was == state:
            return packed
    with torch.no_grad():
        packed = torch.cat([x for wt, bs in zip(weights, biases)
                            for x in (wt.permute(1, 2, 3, 0).reshape(-1), bs.reshape(-1))])
    for k in [k for k, (refs, _, _) in _packs.items() if any(r() is None for r in refs)]:
        del _packs[k]
    _packs[key] = ([weakref.ref(t) for t in tensors], state, packed)
    return packed


def _launch(parts: List[torch.Tensor], weights: Sequence[torch.Tensor],
            biases: Sequence[torch.Tensor], last_linear: bool, out: torch.Tensor) -> None:
    """The kernel call itself (a test can substitute a fake); it overwrites ``out``."""
    b, _, h, w = parts[0].shape
    couts = [wt.shape[0] for wt in weights]
    ks = [wt.shape[2] for wt in weights]
    packed = _packed(weights, biases)
    mid = max(couts[:-1], default=1)
    scratch = torch.empty((2, b * mid * h * w), device=out.device, dtype=torch.float32)
    part_ptrs = (ctypes.c_void_p * len(parts))(*(p.data_ptr() for p in parts))
    part_c = (ctypes.c_int * len(parts))(*(p.shape[1] for p in parts))
    c_ks = (ctypes.c_int * len(ks))(*ks)
    c_couts = (ctypes.c_int * len(couts))(*couts)
    kernels.launch("pivk_conv_chain_f32", "conv_chain", out.device,
                   ctypes.addressof(part_ptrs), ctypes.addressof(part_c), len(parts),
                   ctypes.addressof(c_ks), ctypes.addressof(c_couts), len(ks),
                   packed.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
                   out.data_ptr(), b, h, w, int(last_linear))
