"""The episode drivers on the port: objnav, imagenav, ovnav, textnav,
vlnce, eqa, the memory pre-build and the CSV summary, each the counterpart
of ``benchmarks/<name>.py`` (a performance benchmark is not what these
are; the name ``benchmarks`` is kept for that).  Run one as

    python -m bsc_nav_tpu_torch.drivers.objnav --env fake --llm mock \\
        --device cpu --episodes 2
"""
