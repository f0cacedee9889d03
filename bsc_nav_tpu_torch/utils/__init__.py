"""Host utilities of the port: timing and counters (``profiling``) and the
headless renderers (``visualize``), the counterparts of
``bsc_nav_tpu/utils/``."""
