"""The port's own kernel launches (``kernels/_runtime.DISPATCHES``, equal to
``LAUNCHES`` on the card) a round-slice over the traced passes."""

from olabench import readers


def read(ctx):
    return readers.launches_per_round(ctx)
