"""Mean rounds witnessed by the window's certified queries (a query that
finishes its pass is certified at the last round: its bound is 0)."""

from olabench import readers


def read(ctx):
    return readers.service_value(ctx, "rounds_to_eps_mean")
