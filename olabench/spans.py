"""What the port's own spans and counters (``repro_torch.obs``) say about the
traced passes of a ``passes`` run.

The recorder is on exactly while the benchmark's profiler is, so in a
``--trace 1`` run it holds the traced passes alone.  A reader returns None
outside a ``passes`` run, when nothing was recorded (a port without the
recorder among them), or when the recorded ``pfola.pass`` spans are not
the traced passes.
"""
from __future__ import annotations

from typing import Iterable, Optional


def _store() -> Optional[dict]:
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.summary()


def _traced(ctx) -> Optional[dict]:
    if ctx.get("kind") != "passes" or not ctx.get("traced_passes"):
        return None
    s = _store()
    if s is None or s["spans"].get("pfola.pass", {}).get("count") != ctx["traced_passes"]:
        return None
    return s


def self_time(ctx, names: Iterable[str], per: str, ns_per_unit: float) -> Optional[float]:
    """The self time of the spans ``names`` over the traced stretch, in units
    of ``ns_per_unit``, over ``ctx[per]`` (``traced_passes`` or
    ``traced_rounds``)."""
    s = _traced(ctx)
    if s is None or not ctx.get(per):
        return None
    ns = sum(s["spans"].get(n, {}).get("self_ns", 0) for n in names)
    return ns / ns_per_unit / ctx[per]


def sync_wait_ms(ctx) -> Optional[float]:
    """Host ms a traced pass inside the ``pfola.sync.<site>`` spans."""
    s = _traced(ctx)
    if s is None:
        return None
    ns = sum(v["total_ns"] for k, v in s["spans"].items() if k.startswith("pfola.sync."))
    return ns / 1e6 / ctx["traced_passes"]


def syncs_per_pass(ctx) -> Optional[float]:
    """Host syncs on the card (``pfola.sync``) a traced pass."""
    s = _traced(ctx)
    if s is None:
        return None
    return s["counters"].get("pfola.sync", 0) / ctx["traced_passes"]
