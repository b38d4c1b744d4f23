"""Hand-written CUDA kernels of the port: build, binding and launch checks.

``build.py`` compiles ``csrc/*.cu`` with ``nvcc`` into one C-ABI library and
binds it with ``ctypes``. The wrappers in ``ops/`` use :func:`on_cuda` to pick
the path: a CPU tensor takes the op's plain PyTorch version, a CUDA tensor
launches the kernel (or raises), anything else raises. A kernel has a float32
and a bfloat16 form, C entry points ``pivk_<name>_f32`` and ``pivk_<name>_bf16``
(:func:`entry`); an operand is never converted from one to the other.
"""

from __future__ import annotations

import torch

from piv_liteflownet_tpu_torch.kernels import build

#: Largest element count a kernel indexes with 32-bit ints.
MAX_NUMEL = 2**31 - 1
#: The dtypes the kernels take, and the suffix of their C entry points.
SUFFIXES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_counters: dict[tuple[str, torch.device], torch.Tensor] = {}


def on_cuda(op: str, *tensors: torch.Tensor) -> bool:
    """Check the operands of ``op``; True if they lie on a CUDA device, False on the CPU.

    Every operand must be a contiguous tensor on the same device, all of them float32 or all of
    them bfloat16 (a mix raises: nothing is converted).
    """
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in SUFFIXES:
        raise TypeError(f"{op}: expected float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{op}: operands on different devices ({dev}, {t.device})")
        if t.dtype != dtype:
            raise TypeError(f"{op}: operands of different dtypes ({dtype}, {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{op}: operands must be contiguous")
        if t.numel() > MAX_NUMEL:
            raise ValueError(f"{op}: {t.numel()} elements exceed the kernel's 32-bit indexing")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{op}: no kernel or plain path for device {dev}")
    return True


def entry(name: str, dtype: torch.dtype) -> str:
    """The C entry point of kernel ``name`` for operands of ``dtype``: ``pivk_<name>_f32`` or ``_bf16``."""
    return f"pivk_{name}_{SUFFIXES[dtype]}"


def device_counter(name: str, device: torch.device) -> torch.Tensor:
    """The running count ``name`` (one int32 on ``device``) that a kernel adds to; a caller
    zeroes it to count over a stretch of launches."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:  # the key the kernels' launches use
        device = torch.device("cuda", torch.cuda.current_device())
    key = (name, device)
    if key not in _counters:
        _counters[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _counters[key]


def launch(fn_name: str, op: str, device: torch.device, *args) -> None:
    """Call the C entry point ``fn_name`` on ``device``'s current stream; raise on a CUDA error."""
    lib = build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn_name)(*args, device.index or 0, stream)
    build.check(rc, op)
