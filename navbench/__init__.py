"""navbench: the benchmark of bsc_nav_tpu_torch, the PyTorch and CUDA
port, on NVIDIA H100 cards.

The yardstick lives here and nowhere else: traffic generation
(``scene.py``, ``traffic/``), the seeded weights (``weights.py``), the
arithmetic of least times, rooflines and shares (``arith.py``), the
per-layer readers (``metrics/``), the plain references and the
comparisons that decide ``correct`` (``reference/``, the drivers' checks).
From the program it takes only the system under test.  Nothing here
imports JAX or the JAX package.
"""
