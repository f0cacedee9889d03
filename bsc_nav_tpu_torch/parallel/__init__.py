"""Multi-process parallelism over ``torch.distributed``: the dp x mp mesh
and the tensor-parallel and store layouts (``mesh``), the distributed
top-K over an mp-sharded store (``sharded_query``), the rank launcher
(``launch``) and the multi-rank dry run (``dryrun``).  Counterpart of
``bsc_nav_tpu/parallel/``."""
