"""bsc_nav_tpu_torch -- the PyTorch + CUDA port of bsc_nav_tpu for one
NVIDIA H100.

Module paths mirror the JAX package (``bsc_nav_tpu/memory/ingest.py`` ->
``bsc_nav_tpu_torch/memory/ingest.py``); the JAX package stays the
reference the port is tested against.  This package imports ``torch`` and
never ``jax``, and nothing of ``bsc_nav_tpu``: the port keeps its own copy
of the JAX-free host code it needs (``config``, ``env/{fake,pathfinding}``,
``models/{tokenizer,sentencepiece}``, the host halves of
``models/detector`` and ``agents/matchers``), held equal to the original by
the parity tests.

Every Pallas kernel on the ported path has a hand-written CUDA kernel in
``csrc/`` with a plain PyTorch version beside its wrapper: a tensor on
the CPU takes the plain version, a CUDA tensor launches the kernel (or
the wrapper raises).  Entry points that allocate (model constructors,
loaders, ``init_store``, ``Perception.create``) default to
``device="cuda"`` and raise where there is no card; the CPU is used only
when a caller asks for it.
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matmuls inside run in full f32 (JAX's ``Precision.HIGHEST``),
    whatever the caller's TF32 and float32 matmul precision flags; the
    flags are restored on exit."""
    precision = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)
