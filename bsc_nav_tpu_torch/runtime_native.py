"""ctypes bindings for the native grid runtime (``csrc/navgrid.cpp``).

Counterpart of ``bsc_nav_tpu/runtime_native.py``, over the port's own copy
of the C++ source (held byte-equal to ``runtime/navgrid.cpp`` by the
tests).  The first use builds the shared library with ``g++ -O3
-std=c++17 -shared -fPIC`` into ``build/native/`` at the repository root,
and rebuilds it whenever the source is newer (the pattern of
``ops/_build.py``); nothing is built at import.  A failed build raises
with g++'s stderr.  It exposes:

  - NativeNavGrid: Dijkstra distance fields, A* paths, frontier masks,
    connected-component labels over numpy grids (accelerators for
    env/pathfinding.py and memory/frontier.py on large grids);
  - FrameQueue: a C++ ring buffer staging RGB-D frames + poses into packed
    contiguous batch buffers for the transfer to the card.

``available()`` says whether the library loads.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "navgrid.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
LIB_PATH = BUILD_DIR / "libnavgrid.so"

_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the library if the source is newer than it; raises
    RuntimeError with g++'s stderr when the build fails."""
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SRC.stat().st_mtime:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then an atomic rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(SRC),
           "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=180)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ci = ctypes.c_int
    lib.distance_field.argtypes = [u8p, ci, ci, ci, ci, f32p]
    lib.distance_field.restype = None
    lib.astar_path.argtypes = [u8p, ci, ci, ci, ci, ci, ci, i32p, ci]
    lib.astar_path.restype = ci
    lib.find_frontiers.argtypes = [u8p, u8p, ci, ci, u8p]
    lib.find_frontiers.restype = None
    lib.label_components.argtypes = [u8p, ci, ci, ci, i32p]
    lib.label_components.restype = ci
    lib.fq_create.argtypes = [ci, ci, ci]
    lib.fq_create.restype = ctypes.c_void_p
    lib.fq_destroy.argtypes = [ctypes.c_void_p]
    lib.fq_destroy.restype = None
    lib.fq_size.argtypes = [ctypes.c_void_p]
    lib.fq_size.restype = ci
    lib.fq_push.argtypes = [ctypes.c_void_p, u8p, f32p, f32p]
    lib.fq_push.restype = ci
    lib.fq_pop_batch.argtypes = [ctypes.c_void_p, ci, u8p, f32p, f32p]
    lib.fq_pop_batch.restype = ci
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        _load()
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return False
    return True


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _grid(a, name: str) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint8))
    if a.ndim != 2:
        raise ValueError(f"{name}: a 2-D grid, got shape {a.shape}")
    return a


class NativeNavGrid:
    """Native kernels over a navigability grid (cells, not metres)."""

    def __init__(self, nav: np.ndarray):
        self.lib = _load()
        self.nav = _grid(nav, "nav")
        self.nx, self.nz = self.nav.shape

    def distance_field(self, si: int, sj: int) -> np.ndarray:
        out = np.empty((self.nx, self.nz), np.float32)
        self.lib.distance_field(_u8(self.nav), self.nx, self.nz,
                                si, sj, _f32(out))
        return out

    def astar(self, si: int, sj: int, gi: int, gj: int
              ) -> Optional[np.ndarray]:
        buf = np.empty((self.nx * self.nz, 2), np.int32)
        m = self.lib.astar_path(_u8(self.nav), self.nx, self.nz,
                                si, sj, gi, gj, _i32(buf),
                                self.nx * self.nz)
        if m <= 0:
            return None
        return buf[:m].copy()

    @staticmethod
    def frontiers(known: np.ndarray, navigable: np.ndarray) -> np.ndarray:
        lib = _load()
        known, navigable = _grid(known, "known"), _grid(navigable,
                                                        "navigable")
        if known.shape != navigable.shape:
            raise ValueError(f"known {known.shape} and navigable "
                             f"{navigable.shape} differ")
        nx, nz = known.shape
        out = np.empty((nx, nz), np.uint8)
        lib.find_frontiers(_u8(known), _u8(navigable), nx, nz, _u8(out))
        return out.astype(bool)

    @staticmethod
    def label(mask: np.ndarray, connectivity: int = 4
              ) -> Tuple[np.ndarray, int]:
        lib = _load()
        mask = _grid(mask, "mask")
        nx, nz = mask.shape
        labels = np.empty((nx, nz), np.int32)
        n = lib.label_components(_u8(mask), nx, nz, connectivity,
                                 _i32(labels))
        return labels, n


class FrameQueue:
    """Native frame-staging ring buffer (producer/consumer batching)."""

    def __init__(self, capacity: int, h: int, w: int):
        self.lib = _load()
        self._q = self.lib.fq_create(capacity, h, w)
        self.capacity, self.h, self.w = capacity, h, w

    def __del__(self):
        if getattr(self, "_q", None):
            self.lib.fq_destroy(self._q)
            self._q = None

    def __len__(self) -> int:
        return self.lib.fq_size(self._q)

    def push(self, rgb: np.ndarray, depth: np.ndarray,
             pose: np.ndarray) -> bool:
        rgb = np.ascontiguousarray(np.asarray(rgb)[:, :, :3], np.uint8)
        depth = np.ascontiguousarray(depth, np.float32)
        pose = np.ascontiguousarray(pose, np.float32)
        if (rgb.shape != (self.h, self.w, 3)
                or depth.shape != (self.h, self.w) or pose.size != 7):
            raise ValueError(
                f"frame rgb {rgb.shape}, depth {depth.shape}, pose "
                f"{pose.shape}; the queue holds ({self.h}, {self.w}) frames "
                "and 7-float poses")
        return bool(self.lib.fq_push(self._q, _u8(rgb), _f32(depth),
                                     _f32(pose)))

    def pop_batch(self, n: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        rgb = np.empty((n, self.h, self.w, 3), np.uint8)
        depth = np.empty((n, self.h, self.w), np.float32)
        poses = np.empty((n, 7), np.float32)
        m = self.lib.fq_pop_batch(self._q, n, _u8(rgb), _f32(depth),
                                  _f32(poses))
        return rgb, depth, poses, m
