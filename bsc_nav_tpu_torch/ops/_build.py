"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by one ``nvcc`` call into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), loaded with ``ctypes``.  The library lands in
``build/kernels/`` at the repository root and is rebuilt whenever a
source is newer than it, the pattern ``bsc_nav_tpu/runtime_native.py``
uses for ``runtime/navgrid.cpp``.  Nothing is built at import: the first
kernel launch builds, and a failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libbsc_nav_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                   "bin", "nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if any source is newer than it."""
    srcs = sources()
    if (LIB_PATH.exists() and LIB_PATH.stat().st_mtime
            >= max(s.stat().st_mtime for s in srcs)):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr)
    os.replace(tmp, LIB_PATH)       # atomic: a reader never sees half a file
    return LIB_PATH


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.short_attention_qkv_launch.argtypes = [p, p, i, i, i, i, i, p]
        lib.short_attention_qkv_launch.restype = i
        lib.max_cosine_per_voxel_launch.argtypes = [p, p, p, p, p, i, i, i,
                                                    i, p]
        lib.max_cosine_per_voxel_launch.restype = i
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
