"""The 95th percentile of submit -> certified result over the window's
queries, in a cell where the traced runs show the device idle for more than
half of the window (the host sets the pace); read outside the profiled
stretch."""

from olabench import readers


def read(ctx):
    return readers.service_value(ctx, "latency_p95_ms_untraced")
