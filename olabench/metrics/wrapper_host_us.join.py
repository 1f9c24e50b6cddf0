"""Host us a traced round-slice in routing and the K3 wrappers: the self time
of ``pfola.round``, ``pfola.decode``, ``pfola.project`` (each member's
projection, the probes' gathers among it) and ``pfola.kernel`` (the K3
bundle's wrapper and launch), read by ``wrapper_host_us.report``'s reader;
nothing where the K3 path records no ``pfola.kernel`` span."""

from olabench import bench, spans

_report = bench.metric_reader("wrapper_host_us.report")


def read(ctx):
    s = spans._traced(ctx)
    if s is None or not s["spans"].get("pfola.kernel", {}).get("count"):
        return None
    return _report(ctx)
