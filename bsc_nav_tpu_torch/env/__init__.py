"""The synthetic box-world environment and grid pathfinding: the port's own
copy of ``bsc_nav_tpu/env/{fake,pathfinding}.py`` (no JAX in either)."""
