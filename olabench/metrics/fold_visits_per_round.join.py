"""The (partition, window, chunk) triples the group step's fold visits a
traced round-slice: the ``pfola.fold.visits`` counter (from the launches'
shapes, ``ops.group_step_visits``) over the traced round-slices; nothing
where the program counts none."""

from olabench import spans


def read(ctx):
    s = spans._traced(ctx)
    if s is None or not ctx.get("traced_rounds"):
        return None
    n = s["counters"].get("pfola.fold.visits")
    return None if n is None else n / ctx["traced_rounds"]
