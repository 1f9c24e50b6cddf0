"""Host us a traced round-slice in routing and the kernel wrappers: the self
time of ``pfola.round``, ``pfola.decode``, ``pfola.project`` (the closure
pre-pass's enqueueing) and ``pfola.kernel`` (the wrapper and its launch)."""

from olabench import spans


def read(ctx):
    return spans.self_time(ctx, ("pfola.round", "pfola.decode", "pfola.project", "pfola.kernel"),
                           "traced_rounds", 1e3)
