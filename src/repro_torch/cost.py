"""Loop-aware op counts of an eager step: flops, bytes and collective bytes,
live memory, and a reader of ``torch.profiler`` traces.

Port of ``repro/analysis/hlo_cost.py``.  The reference walks optimized HLO
text: a while body counts ``trip`` times, bytes count at fusion boundaries.
The port compiles nothing; it counts what eager PyTorch dispatches, in a
``TorchDispatchMode`` (:class:`CostCounter`) over a step run on ``meta``
tensors (no memory, no card: the dry run) or on the card.  Per op:

  * flops: a matmul (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
    ``dot``: what ``matmul``, ``einsum`` and ``linear`` lower to) is
    2 · prod(output) · prod(contracting), the reference's dot rule; the
    transcendental ops the reference lists (``exp``, ``tanh``, ``log``,
    ``rsqrt``, ``sqrt``, ``pow``, ``div``, ``sin``, ``cos``, ``sigmoid``,
    ``expm1``, ``log1p``, ``atan2``, ``erf``) are 1 flop an element of their
    output, and so are the fused ops that lower to them in the reference's
    ``jnp`` (:data:`_COMPOSITE`: ``mean`` is a divide an output element,
    ``_softmax`` an exp and a divide an element, ...); everything else 0;
  * bytes: each op's tensor inputs read once and its outputs written once.
    A view (an output on an input's storage) counts 0; an in-place write
    into a slice counts the slice (``copy_`` into a view, ``index_put_``,
    ``scatter_``: the update, not the tensor written into), the counterpart
    of the reference's dynamic-update-slice rule, so a decode step's cache
    write is O(token), not O(cache).  A stride-0 (expanded) dimension is
    read once;
  * collectives: the output bytes of ``torch.distributed``'s all-reduce,
    all-gather, reduce-scatter, all-to-all and send/recv, by the reference's
    kind names.

Loops.  An eager step is a Python loop, so counting every trip is exact —
and slow on ``meta`` when a host loop runs millions of ops (the sLSTM's
token loop, the mLSTM's chunks, the microbatches).  A loop of identical
trips written ``for i in trips(n): ...`` (and its per-trip outputs padded
by :func:`fill_trips`) runs every trip, except under a counter made with
``loop_scaled=True``: there it runs trip 0, trip 1 standing for trips
1..n-2 (counted ``n - 2`` times), and trip n-1, as the reference's
``HloCost`` scales a while body by its trip count.  A middle trip is the
representative: the first trip of a recurrence starts from a state that
needs no gradient, and the last one's state may go unused.
Autograd nodes made inside a scaled trip carry its multiplier
(``node.metadata``), so their backward — and the recompute a checkpointed
trip runs there — counts the same number of times.  A loop-scaled counter
refuses any tensor that is not on ``meta`` (``RuntimeError``): the trips
it leaves out leave their outputs unwritten, which only a count may see.
``tests/test_torch_cost.py`` holds the scaled counts equal to the full
ones.

Memory.  With ``memory=True`` the counter follows every storage an op
allocates until it is freed: ``live_bytes`` and ``peak_bytes``, exact on
``meta`` for the allocations the step makes.  Under loop scaling, a storage
the middle trip allocated that is still live when the last trip ends, as
its twin from trip 0 is (a checkpointed trip's carry, a per-trip output,
what autograd saved), stands for the ``n - 2`` trips' copies: they count
through the last trip and until both storages are freed and the middle
trip's backward is over; :func:`fill_trips`' padding is not counted.  The
tests hold the scaled peak equal to the full one.

``entry_param_bytes`` and ``while_trip_counts`` read compiled HLO text; the
port compiles nothing (its auditor reads exact counters instead), so they
are JAX-only and left out.
"""
from __future__ import annotations

import collections
import math
import sys
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the reference's transcendental HLO opcodes, as aten op names
_TRANSCENDENTAL = ("exp", "tanh", "log", "rsqrt", "sqrt", "pow", "div", "sin", "cos",
                   "sigmoid", "expm1", "log1p", "atan2", "erf")
#: fused aten ops, as the transcendental primitives the reference's jnp
#: lowers them to: flops an element of the first output
_COMPOSITE = {
    "reciprocal": 1,            # divide
    "silu": 1,                  # x * logistic(x)
    "gelu": 1,                  # tanh (approximate) or erf
    "logaddexp": 2,             # exp and log1p
    "softplus": 2,              # logaddexp(x, 0)
    "log_sigmoid_forward": 2,   # -softplus(-x)
    "log_sigmoid_backward": 1,  # logistic
    "_softmax": 2,              # exp and divide
    "_log_softmax": 1,          # exp (and a log a row, below)
    "_log_softmax_backward_data": 1,  # exp
}
_MATMULS = ("mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot")
#: in-place ops that write their first argument without reading it
_WRITE_ONLY = frozenset({"copy_", "fill_", "zero_", "index_put_", "_index_put_impl_",
                         "index_copy_", "scatter_", "masked_fill_", "normal_",
                         "uniform_", "random_", "bernoulli_", "set_", "resize_"})
_INDEXED_WRITES = frozenset({"index_put_", "_index_put_impl_", "index_copy_", "scatter_"})
_ALLOC = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                    "new_empty_strided", "empty_permuted"})


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)

    def __iadd__(self, other: "Cost"):
        self.flops += other.flops
        self.bytes += other.bytes
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) + v
        return self

    def scaled(self, t: float) -> "Cost":
        return Cost(self.flops * t, self.bytes * t,
                    {k: v * t for k, v in self.collective_bytes.items()})

    @property
    def total_collective(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor shows: its shape with the
    stride-0 (expanded) dimensions counted once."""
    n = 1
    for d, s in zip(t.shape, t.stride()):
        if s != 0:
            n *= d
    return n * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _matmul_flops(name: str, args, out) -> float:
    a = args[1] if name in ("addmm", "baddbmm", "addmv") else args[0]
    k = a.shape[-1]
    if name in ("dot", "vdot"):
        return 2.0 * k
    return 2.0 * out.numel() * k


def op_flops(name: str, args, out) -> float:
    """Flops of one aten op (its overload packet's name, in-place ``_``
    stripped) on ``args`` giving ``out``, under the reference's model."""
    base = name.rstrip("_") if name.endswith("_") and not name.startswith("_") else name
    if base in _MATMULS:
        return _matmul_flops(base, args, out)
    first = next(_tensors(out), None)
    if first is None:
        return 0.0
    if base in _TRANSCENDENTAL:
        return float(first.numel())
    if base in _COMPOSITE:
        f = _COMPOSITE[base] * float(first.numel())
        if base == "_log_softmax":
            f += first.numel() / max(first.shape[args[1]] if first.ndim else 1, 1)
        return f
    if base == "mean":
        return float(first.numel())          # the reference's divide by the count
    if base == "logsumexp":
        return float(args[0].numel() + first.numel())   # exp an element, log a row
    return 0.0


def _collective_kind(func) -> Optional[str]:
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional", "_dtensor"):
        return None
    name = func._opname
    if "all_to_all" in name or "alltoall" in name:
        return "all-to-all"
    if "reduce_scatter" in name:
        return "reduce-scatter"
    if "all_gather" in name or "allgather" in name:
        return "all-gather"
    if "all_reduce" in name or "allreduce" in name:
        return "all-reduce"
    if name in ("send", "recv_", "recv_any_source_") or "permute" in name:
        return "collective-permute"
    return None


def _indexed_elems(name: str, args) -> int:
    """Elements an indexed write touches: the update, not the target."""
    self_ = args[0]
    if name in ("index_put_", "_index_put_impl_"):
        idx = list(args[1])
        shapes = [i.shape for i in idx if i is not None]
        if shapes and idx[0] is not None and idx[0].dtype == torch.bool:
            return args[2].numel()
        n = math.prod(torch.broadcast_shapes(*shapes)) if shapes else 1
        rest = [d for i, d in enumerate(self_.shape) if i >= len(idx) or idx[i] is None]
        return n * math.prod(rest)
    if name == "index_copy_":
        return args[3].numel()
    return args[2].numel()                    # scatter_: the index


def _node_trips(node) -> int:
    return node.metadata.get("cost_trips", 1) if node is not None else 1


class _Tagger(TorchFunctionMode):
    """Marks the autograd nodes a scaled trip creates with its multiplier,
    walking back from each call's outputs through the nodes newer than the
    trip's start."""

    def __init__(self, counter: "CostCounter"):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = self.counter
        m = c._forward_trips()
        if m != 1:
            start = c._stack[-1][2]
            todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
            while todo:
                node = todo.pop()
                if node is None or node._sequence_nr() < start or "cost_trips" in node.metadata:
                    continue
                node.metadata["cost_trips"] = m
                node.metadata["cost_loops"] = tuple(lp for _, _, _, lp in c._stack)
                todo.extend(n for n, _ in node.next_functions)
        return out


_COUNTERS: List["CostCounter"] = []


class CostCounter(TorchDispatchMode):
    """Counts the flops, bytes and collective bytes of every op dispatched
    while it is active (``with CostCounter() as c: step(...)``), trip-scaled
    under ``loop_scaled`` (see the module docstring), and with ``memory``
    the live and peak bytes of the storages the ops allocate — an
    allocation whose shape is a key of ``shard_of`` counted at its bytes
    over that key's value (the dry run's parameter-shaped gradients, each
    over its shard count).  ``breakdown=True`` keeps bytes by (op, shape,
    caller) for :meth:`bytes_breakdown`."""

    def __init__(self, *, loop_scaled: bool = False, memory: bool = False,
                 breakdown: bool = False, shard_of: Optional[Dict[tuple, int]] = None):
        super().__init__()
        self.loop_scaled = loop_scaled
        self.memory = memory
        self.shard_of = shard_of or {}
        self.breakdown = breakdown
        self.cost = Cost()
        self.ops: collections.Counter = collections.Counter()
        self.op_flops: collections.Counter = collections.Counter()
        self.op_bytes: Dict[str, float] = collections.defaultdict(float)
        self.live_bytes = 0
        self.peak_bytes = 0
        #: (trips, pushed in backward, first sequence nr, the loop)
        self._stack: list = []
        self._tagger: Optional[_Tagger] = None
        #: storage key -> [weak reference, bytes, the copies it stands for]
        self._known: Dict[int, list] = {}
        self._loops: List[_Loop] = []   # the scaled loops open, innermost last
        self._deferred: list = []       # left-out copies freed inside their loop's backward
        self._untracked = 0

    # -- scopes ------------------------------------------------------------
    def __enter__(self):
        _COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _COUNTERS.remove(self)
        for copies in self._deferred:
            self.live_bytes -= copies[0]
        self._deferred = []
        return super().__exit__(*exc)

    def _push(self, trips: int, loop: "_Loop") -> None:
        in_bwd = torch._C._current_autograd_node() is not None
        self._stack.append((trips, in_bwd, torch._C._autograd._get_sequence_nr(), loop))
        if self._tagger is None:
            self._tagger = _Tagger(self)
            self._tagger.__enter__()

    def _pop(self) -> None:
        self._stack.pop()
        if not self._stack and self._tagger is not None:
            self._tagger.__exit__(None, None, None)
            self._tagger = None

    def _forward_trips(self) -> int:
        return math.prod(t for t, _, _, _ in self._stack)

    def _trips(self) -> int:
        node = torch._C._current_autograd_node()
        if node is None:
            return self._forward_trips()
        return _node_trips(node) * math.prod(t for t, in_bwd, _, _ in self._stack if in_bwd)

    # -- memory ------------------------------------------------------------
    def _track(self, t: torch.Tensor, inputs: set) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in inputs or key in self._known or self._untracked:
            return
        entry = [None, st.nbytes() // self.shard_of.get(tuple(t.shape), 1), []]

        def freed(_ref, key=key, entry=entry, counter=weakref.ref(self)):
            c = counter()
            if c is not None and c._known.get(key) is entry:
                del c._known[key]
                c.live_bytes -= entry[1]
                for copies in entry[2]:       # [bytes, storages still holding them, loop]
                    copies[1] -= 1
                    if copies[1] == 0:
                        c._deferred.append(copies)
                c._release()

        entry[0] = weakref.ref(st, freed)
        self._known[key] = entry
        self.live_bytes += entry[1]
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        for loop in self._loops:
            if loop.trip < 2:
                loop.entries[loop.trip].append((key, entry))
            else:
                loop.peak = max(loop.peak, self.live_bytes)

    def _open_loop(self, trips: int) -> "_Loop":
        loop = _Loop(trips)
        self._loops.append(loop)
        return loop

    def _release(self) -> None:
        """Frees the left-out copies whose storages are gone, except those
        of a loop whose middle trip's backward is running: that backward
        stands for the left-out trips', which free theirs one by one, so
        the copies stay until it is over."""
        node = torch._C._current_autograd_node()
        inside = node.metadata.get("cost_loops", ()) if node is not None else ()
        keep = []
        for copies in self._deferred:
            if copies[2] in inside:
                keep.append(copies)
            else:
                self.live_bytes -= copies[0]
        self._deferred = keep

    def _next_trip(self, loop: "_Loop") -> None:
        loop.trip += 1
        loop.peak = self.live_bytes

    def _close_loop(self, loop: "_Loop") -> None:
        """The last trip has ended.  A storage of the middle trip still live
        whose counterpart in trip 0 (the same allocation of the trip) is
        live too — held across trips, not only by the last trip's locals —
        stands for the trips left out: their copies were live through the
        last trip, and stay live until both storages are freed and the
        middle trip's backward, which stands for theirs, is over
        (:meth:`_release`)."""
        self._loops.remove(loop)
        first, middle = loop.entries
        extra = 0
        for i, (key, entry) in enumerate(middle):
            if self._known.get(key) is not entry:
                continue
            pair = [entry]
            if i < len(first):
                if self._known.get(first[i][0]) is not first[i][1]:
                    continue
                pair.append(first[i][1])
            held = entry[1] + sum(cp[0] for cp in entry[2] if cp[1])
            copies = [(loop.trips - 1) * held, len(pair), loop]
            for e in pair:
                e[2].append(copies)
            extra += copies[0]
        self.live_bytes += extra
        self.peak_bytes = max(self.peak_bytes, loop.peak + extra)
        for outer in self._loops:
            if outer.trip == 2:
                outer.peak = max(outer.peak, loop.peak + extra)

    # -- the op ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._deferred:
            self._release()
        if self.loop_scaled:
            _refuse_off_meta(_tensors((args, kwargs)))
        out = func(*args, **kwargs)
        if self.loop_scaled:
            _refuse_off_meta(_tensors(out))
        name = func._overloadpacket.__name__
        trips = self._trips()
        self.ops[name] += trips
        schema = func._schema
        mutated, unread = [], set()
        for i, sa in enumerate(schema.arguments):
            a = args[i] if i < len(args) else kwargs.get(sa.name)
            if isinstance(a, torch.Tensor) and sa.alias_info is not None and sa.alias_info.is_write:
                mutated.append(a)
                if sa.is_out or name in _WRITE_ONLY:
                    unread.add(id(a))
        ins = list(_tensors((args, kwargs)))
        in_keys = {_storage_key(t) for t in ins if t.layout == torch.strided}
        outs = [t for t in _tensors(out) if t.layout == torch.strided]
        c = Cost()
        kind = _collective_kind(func)
        if kind is not None:
            c.collective_bytes[kind] = float(sum(tensor_bytes(t) for t in (mutated or outs)))
        if mutated:
            read = [t for t in ins if id(t) not in unread]
            if name in _INDEXED_WRITES:
                wb = _indexed_elems(name, args) * args[0].element_size()
            else:
                wb = sum(tensor_bytes(t) for t in mutated)
            c.bytes = float(sum(tensor_bytes(t) for t in read) + wb)
        elif name in _ALLOC or (outs and all(_storage_key(t) in in_keys for t in outs)):
            c.bytes = 0.0                   # an allocation, or a view
        else:
            c.bytes = float(sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs))
        c.flops = op_flops(name, args, out)
        self.cost += c.scaled(trips) if trips != 1 else c
        if c.flops:
            self.op_flops[name] += c.flops * trips
        if self.breakdown and c.bytes:
            self.op_bytes[self._where(name, outs)] += c.bytes * trips
        if self.memory:
            for t in outs:
                self._track(t, in_keys)
        return out

    @staticmethod
    def _where(name: str, outs) -> str:
        shape = "x".join(map(str, outs[0].shape)) if outs else ""
        node = torch._C._current_autograd_node()
        if node is not None:
            return f"{name}:{shape} @backward/{node.name()}"
        f = sys._getframe(2)
        while f is not None:
            mod = f.f_globals.get("__name__", "")
            if mod.startswith("repro_torch.") and mod != __name__:
                return f"{name}:{shape} @{mod[len('repro_torch.'):]}.{f.f_code.co_name}"
            f = f.f_back
        return f"{name}:{shape}"

    # -- results -------------------------------------------------------------
    def total(self) -> Cost:
        return self.cost

    def matmul_flops(self) -> float:
        """The flops of the matmuls alone (the reference's dot rule)."""
        return sum(v for k, v in self.op_flops.items() if k in _MATMULS)

    def count_ops(self, name: str) -> float:
        """Trip-scaled dispatches of the aten op ``name`` (``"mm"``)."""
        return self.ops.get(name, 0)

    def bytes_breakdown(self, top: int = 20):
        """Trip-scaled bytes by (op, output shape, the port function or
        backward node that ran it), largest first (needs ``breakdown``)."""
        return sorted(self.op_bytes.items(), key=lambda kv: -kv[1])[:top]


def _refuse_off_meta(ts) -> None:
    for t in ts:      # an empty tensor holds nothing to leave unwritten (checkpoint's dummy)
        if t.device.type != "meta" and t.numel():
            raise RuntimeError(
                f"a loop-scaled count runs on meta tensors only, not on {t.device}: the "
                "trips it leaves out would leave their outputs unwritten")


class _Loop:
    """A scaled loop's memory record: the trip it is in (0, 1 the middle
    one, 2 the last), the storages trip 0 and the middle trip made
    (``entries``), in order, and, through the last trip, the peak of the
    live bytes (``peak``)."""

    def __init__(self, trips: int):
        self.trips = trips
        self.trip = 0
        self.entries: tuple = ([], [])
        self.peak = 0


def trips(n: int) -> Iterator[int]:
    """The trips a loop of ``n`` identical trips runs: ``range(n)``, or,
    under a loop-scaled :class:`CostCounter`, trip 0, trip 1 counted
    ``n - 2`` times, and trip ``n - 1``."""
    c = _COUNTERS[-1] if _COUNTERS else None
    if c is None or not c.loop_scaled or n <= 3:
        yield from range(n)
        return
    loop = c._open_loop(n - 2)
    try:
        yield 0
        c._next_trip(loop)
        c._push(n - 2, loop)
        try:
            yield 1
        finally:
            c._pop()
        c._next_trip(loop)
        yield n - 1
    finally:
        if loop in c._loops:
            c._close_loop(loop)


def fill_trips(outs: list, n: int) -> list:
    """A loop's per-trip outputs, in trip order, with the trips that
    :func:`trips` left out as unwritten copies (``empty_like``, on ``meta``
    only, and not counted as memory: the middle trip's output counts for
    them) before the last.  Unchanged when every trip ran."""
    if len(outs) >= n:
        return outs
    c = _COUNTERS[-1]
    c._untracked += 1
    try:
        fills = [torch.empty_like(outs[-2]) for _ in range(n - len(outs))]
    finally:
        c._untracked -= 1
    return outs[:-1] + fills + outs[-1:]


def count(fn, *args, loop_scaled: bool = False, memory: bool = False,
          breakdown: bool = False, **kwargs):
    """``fn(*args, **kwargs)`` under a :class:`CostCounter` -> (its result,
    the counter)."""
    with CostCounter(loop_scaled=loop_scaled, memory=memory, breakdown=breakdown) as c:
        out = fn(*args, **kwargs)
    return out, c


def count_ops(fn, opname: str, *args, **kwargs) -> float:
    """Dispatches of the aten op ``opname`` that ``fn(*args, **kwargs)``
    makes, every trip of every loop counted (the reference's
    ``trip_scaled`` total)."""
    _, c = count(fn, *args, **kwargs)
    return c.count_ops(opname)


def analyze(fn, *args, **kwargs) -> dict:
    """The reference's ``analyze`` over an eager call: ``{"flops", "bytes",
    "collective_bytes", "collective_total"}`` of ``fn(*args, **kwargs)``."""
    _, c = count(fn, *args, **kwargs)
    cost = c.total()
    return {"flops": cost.flops, "bytes": cost.bytes,
            "collective_bytes": dict(cost.collective_bytes),
            "collective_total": cost.total_collective}


# ---------------------------------------------------------------------------
# torch.profiler traces
# ---------------------------------------------------------------------------

def _is_device(ev) -> bool:
    from torch.autograd import DeviceType

    return getattr(ev, "device_type", None) == DeviceType.CUDA


def trace_summary(prof, *, top: Optional[int] = 5) -> dict:
    """What a ``torch.profiler`` trace of device activity says: ``kernels``
    (device events, grouped by name, of the names whose device time is
    positive), ``device_ms`` (their summed time), ``busy_ms`` (the union of
    their intervals) over ``window_ms`` (the first event's start to the last
    one's end) as ``busy_share``, the ``top`` entries by device time as
    (name, ms, launches) (every entry when ``top`` is None), and
    ``gemm_ms``, the ms of the entries named ``*gemm*`` (the matmuls).
    ``prof`` is a profile (its ``events()``) or a list of
    ``FunctionEvent``s."""
    events = prof.events() if hasattr(prof, "events") else prof
    dev = [e for e in events if _is_device(e)]
    by_name: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    for e in dev:
        us = e.time_range.end - e.time_range.start
        by_name[e.key][0] += us
        by_name[e.key][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    rows = sorted(((k, us, n) for k, (us, n) in by_name.items() if us > 0),
                  key=lambda r: -r[1])
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    window = (max(b for _, b in spans) - min(a for a, _ in spans)) if spans else 0.0
    return {"kernels": sum(n for _, _, n in rows),
            "device_ms": sum(us for _, us, _ in rows) / 1e3,
            "busy_ms": busy / 1e3,
            "window_ms": window / 1e3,
            "busy_share": busy / window if window > 0 else 0.0,
            "top": [(k, us / 1e3, n) for k, us, n in (rows if top is None else rows[:top])],
            "gemm_ms": sum(us for k, us, _ in rows if "gemm" in k.lower()) / 1e3}
