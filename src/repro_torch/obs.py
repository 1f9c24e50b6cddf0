"""Spans and counters of the port's own layers, kept in memory.

A span is a named stretch of host time at a layer boundary::

    with obs.span("pfola.merge"):
        ...

Recording is on exactly while a ``torch.profiler`` session is active (the
benchmark's traced runs) or inside ``with obs.recording():`` (the
operator's switch).  Off, :func:`span` tests that and hands back the one
shared :data:`OFF` span, which reads no clock, records nothing and enters
nothing.

On, a span keeps its name, ``time.perf_counter_ns()`` at its start and end,
its id, its parent's id (the innermost span open on its thread), the id of
the pass or query it belongs to (:func:`root` opens a pass, :func:`begin`
a query) and its attributes; and it adds to its name's totals: count, total
ns, and self ns (its duration less the part its children cover).  Raw spans
are kept up to :data:`CAP`, the totals always.  Under a profiler each span
is also a host range of the profile, so that an idle gap of the trace is
named by the port's span over it.  The range is a FUNCTION-scope record
(``_RecordFunctionFast``), not ``record_function``'s user annotation: the
profiler mirrors a user annotation onto the device's timeline as a
``gpu_user_annotation`` event, which a trace reducer would count as device
work.

While a span is open on a CUDA process, ``torch.cuda.set_sync_debug_mode``
is ``"warn"``: each warning it raises is swallowed and counted as
:data:`SYNC` under the innermost open span.  A sync outside every span
(a caller's own ``synchronize``) is not counted.  The blocking sites of the
report path carry spans ``pfola.sync.<site>`` so that each wait has a
duration.

Spans of the port (PERF.md §3 names each with what reads it): ``pfola.pass``,
``pfola.session.init``, ``pfola.scan``, ``pfola.round``, ``pfola.decode``,
``pfola.project``, ``pfola.kernel``, ``pfola.merge``, ``pfola.estimate``,
``pfola.sync.<site>``, ``pfola.serve.step`` and ``pfola.query``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _prof

#: raw spans kept (about 250 B each); the per-name totals have no cap
CAP = 1 << 18
#: the counter of host syncs on the card
SYNC = "pfola.sync"
#: what ``set_sync_debug_mode("warn")`` says at each sync
SYNC_WARNING = "called a synchronizing CUDA operation"
#: what ``set_sync_debug_mode`` itself says when it turns the warnings on
_MODE_WARNING = "Synchronization debug mode is a prototype"

_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class Record(NamedTuple):
    """One closed span.  ``parent`` and ``group`` are 0 where there is none;
    ``group`` is the id of the pass or query the span belongs to."""

    name: str
    id: int
    parent: int
    group: int
    start_ns: int
    end_ns: int
    self_ns: int
    attrs: Optional[dict]


class _Off:
    """The span that recording off hands out."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def note(self, **attrs) -> None:
        pass


OFF = _Off()


class _Recorder:
    """The process's spans, totals and counters, and the sync hooks while a
    span is open."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.forced = 0
        self.open_threads = 0
        self.hooks = None
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.ids = itertools.count(1)
            self.records: List[tuple] = []
            self.dropped = 0
            self.totals: Dict[str, list] = {}
            self.counters: Dict[str, int] = {}
            self.by_span: Dict[str, Dict[Optional[str], int]] = {}

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def close(self, name, id_, parent, group, t0, t1, self_ns, attrs) -> None:
        with self.lock:
            t = self.totals.get(name)
            if t is None:
                t = self.totals[name] = [0, 0, 0]
            t[0] += 1
            t[1] += t1 - t0
            t[2] += self_ns
            if len(self.records) < CAP:
                self.records.append((name, id_, parent, group, t0, t1, self_ns, attrs))
            else:
                self.dropped += 1

    def add(self, name: str, n: int, under: Optional[str]) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n
            per = self.by_span.setdefault(name, {})
            per[under] = per.get(under, 0) + n

    # -- the sync hooks: armed while any thread has a span open -------------

    def arm(self) -> None:
        with self.lock:
            self.open_threads += 1
            if self.open_threads > 1:
                return
            cw = warnings.catch_warnings()
            cw.__enter__()
            warnings.filterwarnings("always", message=SYNC_WARNING)
            warnings.filterwarnings("ignore", message=_MODE_WARNING)
            shown = warnings._showwarnmsg
            warnings._showwarnmsg = self._show
            mode = None
            if torch.cuda.is_initialized():
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            self.hooks = (cw, shown, mode)

    def disarm(self) -> None:
        with self.lock:
            self.open_threads -= 1
            if self.open_threads > 0 or self.hooks is None:
                return
            cw, shown, mode = self.hooks
            self.hooks = None
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
            warnings._showwarnmsg = shown
            cw.__exit__(None, None, None)

    def _show(self, msg) -> None:
        if not str(msg.message).startswith(SYNC_WARNING):
            hooks = self.hooks
            (warnings._showwarnmsg_impl if hooks is None else hooks[1])(msg)
            return
        if self.stack():  # a sync outside every span is the caller's
            count(SYNC)


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "attrs", "root", "id", "parent", "group", "t0", "child_ns", "range")

    def __init__(self, name: str, attrs: dict, root: bool):
        self.name, self.attrs, self.root = name, attrs or None, root

    def __bool__(self):
        return True

    def note(self, **attrs) -> None:
        """Add attributes known only once the span's work has run."""
        self.attrs = {**(self.attrs or {}), **attrs}

    def __enter__(self):
        stack = _REC.stack()
        self.id = next(_REC.ids)
        if stack:
            top = stack[-1]
            self.parent, self.group = top.id, self.id if self.root else top.group
        else:
            _REC.arm()
            self.parent, self.group = 0, self.id if self.root else 0
        self.child_ns = 0
        self.range = None
        if _RANGE is not None and _prof._is_profiler_enabled:
            self.range = _RANGE(self.name)
            self.range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        stack = _REC.stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        dur = t1 - self.t0
        if stack:
            stack[-1].child_ns += dur
        _REC.close(self.name, self.id, self.parent, self.group, self.t0, t1,
                   dur - self.child_ns, self.attrs)
        if not stack:
            _REC.disarm()
        return False


class Query:
    """An open span that is no thread's child: a query from its submit to
    its result (:func:`begin`, :func:`end`).  ``id`` is the query id."""

    __slots__ = ("name", "id", "parent", "t0", "attrs", "open")

    def __init__(self, name: str, attrs: dict):
        stack = _REC.stack()
        self.name, self.attrs, self.open = name, attrs or None, True
        self.id = next(_REC.ids)
        self.parent = stack[-1].id if stack else 0
        self.t0 = time.perf_counter_ns()


def span(name: str, **attrs):
    """A span of the current pass or query; :data:`OFF` when not recording."""
    if not (_REC.forced or _prof._is_profiler_enabled):
        return OFF
    return _Span(name, attrs, False)


def root(name: str, **attrs):
    """A span that opens a new pass: it and the spans under it carry its id
    as their ``group``."""
    if not (_REC.forced or _prof._is_profiler_enabled):
        return OFF
    return _Span(name, attrs, True)


def begin(name: str, **attrs) -> Optional[Query]:
    """Open a span that outlives the call that opens it (a query, from its
    submit to its result); None when not recording."""
    if not (_REC.forced or _prof._is_profiler_enabled):
        return None
    return Query(name, attrs)


def end(q: Optional[Query]) -> None:
    """Close what :func:`begin` opened; once, whatever the number of calls."""
    if q is None or not q.open:
        return
    q.open = False
    t1 = time.perf_counter_ns()
    _REC.close(q.name, q.id, q.parent, q.id, q.t0, t1, t1 - q.t0, q.attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` under the innermost open span."""
    if not (_REC.forced or _prof._is_profiler_enabled):
        return
    stack = _REC.stack()
    _REC.add(name, n, stack[-1].name if stack else None)


@contextlib.contextmanager
def recording():
    """Record spans and counters inside this block, profiler or not."""
    _REC.forced += 1
    try:
        yield
    finally:
        _REC.forced -= 1


def summary() -> dict:
    """Totals of every span name (``count``, ``total_ns``, ``self_ns``),
    the counters, each counter by the span it was counted under
    (``counters_by_span``; None: outside every span), and the raw spans
    kept and dropped."""
    with _REC.lock:
        return {
            "spans": {k: {"count": c, "total_ns": t, "self_ns": s}
                      for k, (c, t, s) in _REC.totals.items()},
            "counters": dict(_REC.counters),
            "counters_by_span": {k: dict(v) for k, v in _REC.by_span.items()},
            "records": len(_REC.records),
            "dropped": _REC.dropped,
        }


def records() -> List[Record]:
    """The raw spans kept, in the order they closed."""
    with _REC.lock:
        return [Record(*r) for r in _REC.records]


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _REC.reset()
