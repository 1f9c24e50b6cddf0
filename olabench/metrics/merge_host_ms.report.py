"""Host ms a traced pass in plan, merge and estimate: the self time of
``pfola.scan``, ``pfola.merge`` and ``pfola.estimate``; the waits on the card
are their ``pfola.sync.<site>`` children, not counted here."""

from olabench import spans


def read(ctx):
    return spans.self_time(ctx, ("pfola.scan", "pfola.merge", "pfola.estimate"),
                           "traced_passes", 1e6)
