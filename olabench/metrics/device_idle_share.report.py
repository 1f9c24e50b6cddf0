"""Device idle share of the traced slice of a ``report`` window, in %: 1 - the union
of device event intervals / the slice."""

from olabench import readers


def read(ctx):
    return readers.idle_share(ctx, "passes")
