"""Host milliseconds a serving step: window seconds over the steps
``SharedScan.steps_done`` counts (outside the profiled stretch)."""

from olabench import readers


def read(ctx):
    return readers.service_value(ctx, "step_ms")
