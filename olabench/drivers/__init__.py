"""Traffic drivers added as files of their own (``run.driver_module``)."""
