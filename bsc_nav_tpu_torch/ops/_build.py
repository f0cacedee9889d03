"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, into an object with a plain C interface (no PyTorch
headers, so a source takes seconds); one more ``nvcc`` links the objects
into one shared library, loaded with ``ctypes``.  The library lands in
``build/kernels/`` at the repository root and is rebuilt whenever a source
or a ``csrc/*.cuh`` header is newer than it, the pattern
``bsc_nav_tpu/runtime_native.py`` uses for ``runtime/navgrid.cpp``.
Nothing is built at import: the first kernel launch builds, and a failed
build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libbsc_nav_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_lib: Optional[ctypes.CDLL] = None
# source name -> ptxas -v's report of its kernels, from a verbose build
ptxas_log: dict = {}


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


def _run(cmd: list) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    return proc


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if any source or header is newer than
    it.  ``verbose`` prints ptxas's registers and shared memory per
    kernel."""
    srcs = sources()
    deps = srcs + sorted(CSRC.glob("*.cuh"))
    if (LIB_PATH.exists() and LIB_PATH.stat().st_mtime
            >= max(s.stat().st_mtime for s in deps)):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = [*NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp, s.stem + ".o")) for s in srcs]
        with ThreadPoolExecutor(len(srcs)) as pool:
            procs = list(pool.map(
                lambda so: _run([nvcc, *flags, "-c", "-o", so[1], str(so[0])]),
                zip(srcs, objs)))
        if verbose:
            for src, p in zip(srcs, procs):
                ptxas_log[src.name] = p.stderr
                if p.stderr:
                    print(p.stderr)
        lib = str(Path(tmp, LIB_PATH.name))
        _run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib, *objs])
        os.replace(lib, LIB_PATH)   # atomic: a reader never sees half a file
    return LIB_PATH


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name, args in (
                ("short_attention_qkv", [p, p, i, i, i, i, i, p]),
                ("short_attention", [p, p, p, p, i, i, i, i, i, i, p]),
                ("max_cosine_per_voxel", [p, p, p, p, p, i, i, i, i, p]),
                ("max_cosine_batch", [p, p, p, p, p, i, i, i, i, i, p]),
                ("joint_qkv_attention", [p, p, p, p, p, i, i, i, i, f, i, p]),
                ("joint_qk_norm", [p, p, p, p, i, i, i, i, f, i, p]),
                ("mid_attention", [p, p, p, p, i, i, i, i, i, p]),
                ("flash_attention", [p, p, p, p, i, i, i, i, i, i, p]),
                ("layer_norm", [p, p, p, p, ctypes.c_longlong, i, f, i, p]),
                ("conv3x3_s1", [p, p, p, p, i, i, i, i, i, i, i, p])):
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes, fn.restype = args, i
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
