"""Host utilities of the port: timing, tracing and counters
(``profiling``: the counterparts of ``bsc_nav_tpu/utils/``'s, and the
program's own spans and counters of the memory build, ``SPANS`` and
``TELEMETRY``) and the headless renderers (``visualize``)."""
