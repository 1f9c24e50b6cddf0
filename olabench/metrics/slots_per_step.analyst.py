"""Live slots a serving step: the rounds witnessed by every answered query of
the run over the run's steps (``QueryOutcome.rounds_witnessed``,
``SharedScan.steps_done``)."""

from olabench import readers


def read(ctx):
    return readers.service_value(ctx, "slots_per_step")
