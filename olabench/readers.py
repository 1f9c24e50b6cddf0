"""What the per-layer metrics read from a run's context.

Each metric is a file of its own (``metrics/<name>.py``) that binds one of
these to the traffic kind and pacing of the cells it is read in; a reader
returns None where the run holds nothing for it, never 0 for a share.
"""
from __future__ import annotations

from olabench.roofline import HBM_BYTES_PER_S


def _trace(ctx, kind):
    t = ctx.get("trace")
    return t if ctx.get("kind") == kind and t and t.get("window_s") else None


def idle_share(ctx, kind):
    """1 - the union of device event intervals / the traced slice, in %."""
    t = _trace(ctx, kind)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(ctx, kind):
    """The bytes the traced work needs (``roofline.py``) over 3.35 TB/s,
    against the device-busy seconds of the traced slice, in %."""
    t = _trace(ctx, kind)
    if t is None or not t["busy_s"] or not ctx.get("traced_needed_bytes"):
        return None
    return 100.0 * ctx["traced_needed_bytes"] / HBM_BYTES_PER_S / t["busy_s"]


def kernels_per_round(ctx):
    """Device events (kernels, copies) a round-slice in the traced passes."""
    t = _trace(ctx, "passes")
    return None if t is None or not ctx.get("traced_rounds") else t["kernels"] / ctx["traced_rounds"]


def launches_per_round(ctx):
    """The port's own kernel launches (``_runtime.DISPATCHES``) a round-slice
    over the traced passes."""
    if ctx.get("kind") != "passes" or ctx.get("traced_launches") is None or not ctx.get("traced_rounds"):
        return None
    return ctx["traced_launches"] / ctx["traced_rounds"]


def service_value(ctx, key):
    """A number the service driver counted (``step_ms``, ``slots_per_step``,
    ``rounds_to_eps_mean``, ``latency_p95_ms``)."""
    return ctx.get(key) if ctx.get("kind") == "service" else None
