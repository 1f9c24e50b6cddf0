"""Device events (the closure pre-pass's kernels, the port's, copies) a
round-slice in the traced passes."""

from olabench import readers


def read(ctx):
    return readers.kernels_per_round(ctx)
