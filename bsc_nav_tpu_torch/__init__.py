"""bsc_nav_tpu_torch -- the PyTorch + CUDA port of bsc_nav_tpu for one
NVIDIA H100.

Module paths mirror the JAX package (``bsc_nav_tpu/memory/ingest.py`` ->
``bsc_nav_tpu_torch/memory/ingest.py``); the JAX package stays the
reference the port is tested against.  This package imports ``torch`` and
never ``jax``.  It shares the JAX-free host code of ``bsc_nav_tpu`` by
import: ``bsc_nav_tpu.config`` and ``bsc_nav_tpu.env``.

Every Pallas kernel on the ported path has a hand-written CUDA kernel in
``csrc/`` with a plain PyTorch version beside its wrapper: a tensor on
the CPU takes the plain version, a CUDA tensor launches the kernel (or
the wrapper raises).
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and
    this process has no CUDA card (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False")
    return dev
