"""The synthetic box-world environment, grid pathfinding, the benchmark
environment and the VLN-CE map measure: the port's own copies of
``bsc_nav_tpu/env/{fake,pathfinding,benchmark,vlnce_maps}.py`` (no JAX in
any)."""
