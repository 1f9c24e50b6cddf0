"""What a ``torch.profiler`` trace of a slice of the window says.

Device time is the union of the intervals of every device event (kernels,
copies, sets); the slice is the host clock's from the profiler's start to
its stop.  An idle gap is named by the innermost host operation recorded
over its middle, or ``host:python`` where none was (interpreter time
between operations).
"""
from __future__ import annotations

import collections
import time
from typing import List, Optional, Tuple

NAME_CHARS = 120  # a device op's name is cut there: CUDA template names run to kilobytes


class Tracer:
    """Starts and stops one profile and reduces it (``summary``)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    @property
    def window_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def summary(self, top: int = 10) -> dict:
        return summarize(self.prof.events(), self.window_s, top)


def _union(spans: List[Tuple[float, float]]):
    """(busy length, the merged intervals) of ``spans``, sorted."""
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def summarize(events, window_s: float, top: int = 10) -> dict:
    """``busy_s``, ``window_s``, ``kernels`` (device events), ``device_ops``
    and ``idle_gaps`` (each ``top`` entries of [name, seconds]) of a list
    of profiler events (``FunctionEvent``s: ``device_type``, ``key``,
    ``time_range`` in microseconds)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        (dev if e.device_type == DeviceType.CUDA else host).append((span, e.key))
    by_name = collections.defaultdict(float)
    for (a, b), name in dev:
        by_name[name] += b - a
    busy_us, merged = _union([s for s, _ in dev])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        over = [(e - s, name) for (s, e), name in host if s <= mid <= e]
        named.append([min(over)[1] if over else "host:python", (b - a) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us / 1e6, "window_s": window_s, "kernels": len(dev),
            "device_ops": [[k[:NAME_CHARS], us / 1e6] for k, us in ops], "idle_gaps": named}
