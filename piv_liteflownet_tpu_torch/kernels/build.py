"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` (one ``nvcc`` per source,
all started together) and linked into one shared library with a plain C
interface, ``build/torch_kernels/libpivk.so`` under the repository root.
Nothing includes PyTorch's headers, so a build takes seconds. The library is
rebuilt when the hash of the sources or of the flags changes, and is built at
first use: importing this module starts nothing.

Each C function takes ``void*`` pointers, ``int`` sizes, the CUDA device index
and the ``cudaStream_t`` to launch on, and returns ``cudaGetLastError()``. A
kernel's float32 form is ``pivk_<name>_f32``, its bfloat16 form, where it has
one, ``pivk_<name>_bf16``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
LIB_NAME = "libpivk.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of every kernel entry point: name -> argtypes.
SIGNATURES = {
    "pivk_corr49_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "pivk_backwarp_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "pivk_rgb_warp_norm_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "pivk_backwarp_bwd_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "pivk_corr49_bwd_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "pivk_conv_chain_f32": (_P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}
#: The bfloat16 forms take the arguments of their float32 forms; the backwarp gradient's also
#: takes, after its counter, a float32 workspace of the image's shape.
SIGNATURES.update({name.replace("_f32", "_bf16"): SIGNATURES[name] for name in
                   ("pivk_corr49_f32", "pivk_backwarp_f32", "pivk_rgb_warp_norm_f32",
                    "pivk_corr49_bwd_f32")})
SIGNATURES["pivk_backwarp_bwd_bf16"] = (SIGNATURES["pivk_backwarp_bwd_f32"][:6] + (_P,)
                                        + SIGNATURES["pivk_backwarp_bwd_f32"][6:])


@dataclass(frozen=True)
class BuildResult:
    path: Path
    rebuilt: bool
    seconds: float
    log: str  # the compilers' output (ptxas register and spill report)


def sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_digest() -> str:
    """Hash of every source's name and bytes plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    return h.hexdigest()


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
        "kernels can only be built on a machine with the CUDA toolkit")


def build(nvcc: str | None = None, force: bool = False) -> BuildResult:
    """Compile ``csrc/*.cu`` into ``libpivk.so`` unless an up-to-date build exists."""
    digest = source_digest()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if (not force and lib_path.is_file() and stamp.is_file()
            and stamp.read_text().strip() == digest):
        return BuildResult(lib_path, False, 0.0, "")
    nvcc = nvcc or find_nvcc()
    if not os.path.isfile(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src), "-o", str(obj)]
            procs.append((src.name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        os.replace(tmp_lib, lib_path)
    stamp.write_text(digest + "\n")
    return BuildResult(lib_path, True, time.perf_counter() - t0, "\n".join(logs))


_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every ``argtypes`` set."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.pivk_error_string.argtypes = (ctypes.c_int,)
            lib.pivk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = load().pivk_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")
