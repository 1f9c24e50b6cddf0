"""Host ms a traced pass in the port's entry layer: the self time of
``pfola.pass`` (``engine.run_queries``) and ``pfola.session.init``."""

from olabench import spans


def read(ctx):
    return spans.self_time(ctx, ("pfola.pass", "pfola.session.init"), "traced_passes", 1e6)
