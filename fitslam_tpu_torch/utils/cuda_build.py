"""Build and load the port's native libraries: the CUDA kernels
(``fitslam_tpu_torch/csrc/*.cu``) and the host runtime (``csrc/runtime.cc``).

Each kernel source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, under
``build/kernels/`` at the repository root (git-ignored); the host runtime is
compiled by ``g++`` with the flags of the reference's ``native/Makefile``
into ``build/native/``. A library's name carries a hash of its source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. Libraries are loaded with ``ctypes``; the kernel wrappers in ``ops/``
pass raw device pointers and PyTorch's current stream. A failed build raises
with the compiler's output: nothing falls back.

Nothing here runs at import time: this module is imported on machines that
have neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NATIVE_BUILD_DIR = BUILD_DIR.parent / "native"

# --fmad=false: K2's window gate forms dx*dx + dy*dy without a fused
# multiply-add, as the reference does (the gate also uses __fmul_rn /
# __fadd_rn, so this is belt and braces). -Xptxas -v reports registers,
# shared memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")

_loaded: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _library_path(src: Path, flags, out_dir: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    return out_dir / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _build(compiler: str, flags, src: Path, out_dir: Path) -> Tuple[Path, str]:
    """Compile ``src`` unless its hashed library exists. Returns (library
    path, the compiler's output; empty when nothing was built)."""
    out = _library_path(src, flags, out_dir)
    if out.exists():
        return out, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(compiler).name} failed for {src.name}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders never see a partial file
    return out, proc.stdout + proc.stderr


def build_kernel_library(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.
    Returns (library path, nvcc's output; empty when nothing was built)."""
    return _build(nvcc_path(), NVCC_FLAGS, CSRC_DIR / f"{name}.cu", BUILD_DIR)


def gxx_path() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the native host runtime needs a C++ compiler")


def build_host_library(src: Path = CSRC_DIR / "runtime.cc") -> Tuple[Path, str]:
    """Compile the host runtime with g++ into ``build/native/`` unless its
    hashed library exists. Returns (library path, g++'s output)."""
    return _build(gxx_path(), GXX_FLAGS, src, NATIVE_BUILD_DIR)


def load_kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        path, log = build_kernel_library(name)
        _loaded[name] = (ctypes.CDLL(str(path)), log)
    return _loaded[name][0]


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) for a library
    built by this process; empty if it was loaded from an earlier build."""
    return _loaded[name][1] if name in _loaded else ""


def check_cuda_error(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
