"""Host ms a traced pass waiting on the card at the port's blocking sites:
the ``pfola.sync.<site>`` spans."""

from olabench import spans


def read(ctx):
    return spans.sync_wait_ms(ctx)
