"""Interactive OLA sessions — the paper's headline user feature, §1/§3.4.

Port of ``repro/core/session.py:101-1118``: the user stops the
computation as soon as the estimate is accurate
enough.  A :class:`Session` either runs the whole-scan program (no stopping
rule — byte-for-byte ``engine.run_query``'s path) or advances the scan one
round-slice at a time and evaluates a stopping rule between rounds, so a
query over N rounds that converges at round k pays only k/N of the scan.

Per round-slice the ``"scan"`` path folds the GLA's ``accumulate`` chunk by
chunk.  ``emit="kernel"`` picks its path as the reference does: the
carry-style ``"kernel_fused"`` (one K1 launch covering every partition and
every bundle member) whenever the fused contract can be used, else a
delta-style legacy path — ``"kernel_bundle"`` and ``"kernel_group"`` (one
K3 launch per round-slice) or ``"kernel_scalar"`` (one K4 launch) — whose
first round's state IS the round's delta and whose later rounds add onto
it.  Every path but ``"kernel_scalar"`` keeps the whole-scan program's
association, so stepping round by round gives its states bit for bit.
A bundle's stopping rule holds only when every member that estimates has
converged.

The data is a shards dict or any ``repro_torch.data.source.ChunkSource``
(port of ``repro/core/session.py:362-410,445-560,621-641,766-789``).  A
resident source keeps the whole-scan program; a streaming one
(``NpyMmapSource``, ``EncodedSource``) is scanned round by round, even
without a stopping rule, through :class:`_SlicePrefetcher`: double
buffering with pinned host staging buffers, a side CUDA stream and
events, so at most two round-slices are on the card and finals,
snapshots and bounds are bitwise the resident run's.  An encoded source's
physical columns are decoded on the device — by the fused step on the
``kernel_fused`` path, by :func:`repro_torch.data.encodings.decode_cols`
before every other path.  A view over resident data whose slices are
gathered on the device (``RepartitionedSource``) is stepped round by round
without host staging.

Failures (paper §4.6 live): a :class:`FaultPolicy` injects partition loss
at given rounds, or survives a ``PartitionLostError`` that a streaming
source raises mid-scan, and applies its estimation model's consequences
round by round (``repro_torch.fault``).  :meth:`Session.pause` checkpoints
the per-partition carries and the scan cursor (``repro_torch.ckpt``);
:meth:`Session.resume` continues from that round boundary, in this process
or another, bitwise the uninterrupted run, or on another partition count
(elastic resume: ``scan.merge_carries``/``split_carries`` over a
``RepartitionedSource``).

``mesh=`` (a ``repro_torch.sharded.PartitionGroup``) makes the session one
rank of several: every rank builds it with the same plan and calls the same
methods in the same order; each steps its own partitions, and the rounds'
merges, estimates, stopping decisions, failures and checkpoints are the
whole query's, bitwise the one-process session's (``repro_torch.sharded``).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch import engine as EN
from repro_torch import fault as FT
from repro_torch import obs
from repro_torch import scan as SC
from repro_torch import sharded as SH
from repro_torch import spec as QS
from repro_torch._device import resolve_device
from repro_torch.data import encodings as ENC
from repro_torch.data import source as DS
from repro_torch.uda import GLA, Estimate, tree_stack

Pytree = Any

# the reference's v3 field set (per-partition cursors, the runtime failure
# record, the fault estimator family) plus the framework that wrote it
_CKPT_VERSION = 3


# ---------------------------------------------------------------------------
# stopping rules
# ---------------------------------------------------------------------------

class RoundProgress(NamedTuple):
    """What a stopping rule sees after each round.  ``estimates`` is the
    round's Estimate, a tuple of one per member (``None`` for members
    without an estimation model) for a bundle, or ``None``."""

    round: int  # rounds completed so far (1-based)
    rounds_total: int
    estimates: Any  # the round's Estimate, or None without an estimator
    scanned: float  # tuples scanned so far across all partitions
    d_total: float
    elapsed_s: float  # driver wall time


StoppingRule = Callable[[RoundProgress], bool]


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def _per_estimate(estimates, pred) -> bool:
    """True when ``pred`` holds for every available member estimate.

    ``None`` (no estimation model anywhere) can never attest convergence.
    For a bundle, members without an estimator are skipped and every other
    member must pass: the all-queries-converged rule.
    """
    if estimates is None:
        return False
    members = ((estimates,) if isinstance(estimates, Estimate)
               else tuple(estimates))
    present = [e for e in members if e is not None]
    return bool(present) and all(pred(e) for e in present)


def _half_widths(est) -> np.ndarray:
    return (_np64(est.upper) - _np64(est.lower)) / 2.0


def rel_width(eps: float, *, min_rounds: int = 1) -> StoppingRule:
    """Stop once every aggregate's CI half-width ≤ ``eps`` · |estimate|.

    Every aggregate (and group) must converge.  Zero half-widths (e.g. empty
    groups) count as converged; infinite ones (the |S| ≤ 1 variance clamp)
    never do.
    """
    def converged(e):
        half = _half_widths(e)
        mid = np.abs(_np64(e.estimate))
        rel = np.where(half == 0.0, 0.0, half / np.maximum(mid, 1e-300))
        return bool(rel.size == 0 or np.max(rel) <= eps)

    def rule(prog: RoundProgress) -> bool:
        if prog.round < min_rounds:
            return False
        return _per_estimate(prog.estimates, converged)

    return rule


def abs_width(limit: float, *, min_rounds: int = 1) -> StoppingRule:
    """Stop once every aggregate's CI half-width ≤ ``limit`` (absolute)."""
    def converged(e):
        half = _half_widths(e)
        return bool(half.size == 0 or np.max(half) <= limit)

    def rule(prog: RoundProgress) -> bool:
        if prog.round < min_rounds:
            return False
        return _per_estimate(prog.estimates, converged)

    return rule


def budget(*, max_seconds: Optional[float] = None,
           max_tuples: Optional[float] = None,
           max_rounds: Optional[int] = None) -> StoppingRule:
    """Stop when any resource budget is exhausted, converged or not."""
    def rule(prog: RoundProgress) -> bool:
        if max_seconds is not None and prog.elapsed_s >= max_seconds:
            return True
        if max_tuples is not None and prog.scanned >= max_tuples:
            return True
        return max_rounds is not None and prog.round >= max_rounds

    return rule


def any_of(*rules: StoppingRule) -> StoppingRule:
    """Stop when ANY rule fires (e.g. converged OR out of time budget)."""
    return lambda prog: any(r(prog) for r in rules)


def all_of(*rules: StoppingRule) -> StoppingRule:
    """Stop only when EVERY rule fires."""
    return lambda prog: all(r(prog) for r in rules)


# ---------------------------------------------------------------------------
# runtime failure handling (paper §4.6 live)
# ---------------------------------------------------------------------------

class FaultPolicy:
    """Make mid-scan partition loss survivable instead of fatal.

    Attach to a :class:`Session` (``QuerySpec(..., fault=FaultPolicy(...))``)
    and failures degrade the answer instead of ending the scan.  They
    arrive two ways:

      * *injected* — ``fail_at`` maps partition -> failure round, the
        ``repro_torch.fault.failure_schedule`` convention: ``fail_at[p] ==
        0`` is dead from the start, and partition p's state is excluded
        from every merge from round ``fail_at[p]`` on;
      * *detected* — a streaming source's read raises
        ``PartitionLostError``; the session records the current round as
        those partitions' failure round and reads the slice again (the
        source serves them zeroed from then on).

    ``estimator`` names the estimation model the GLA was built with:
    ``single`` survives (the alive-weighted merge renormalizes, and the
    variance floor keeps bounds finite), ``multiple`` is poisoned (bounds
    (-inf, +inf) from the failure round on), ``synchronized`` freezes at
    the last pre-failure round.  Excluding dead partitions is a weighted
    merge, so the session requires ``gla.merge_is_additive``.
    """

    _ESTIMATORS = ("single", "multiple", "synchronized")

    def __init__(self, estimator: str = "single", *,
                 fail_at: Optional[Mapping[int, int]] = None):
        if estimator not in self._ESTIMATORS:
            raise ValueError(
                f"unknown estimator model {estimator!r}; expected one of "
                f"{self._ESTIMATORS}")
        self.estimator = estimator
        self.fail_at = {int(p): int(r) for p, r in (fail_at or {}).items()}
        for p, r in self.fail_at.items():
            if p < 0 or r < 0:
                raise ValueError(
                    f"fail_at maps partition -> failure round, both >= 0; "
                    f"got {{{p}: {r}}}")


def _map_member_ests(fn, est):
    """Apply ``fn`` to an Estimate, member-wise for a bundle's tuple
    (members without an estimation model pass through as None)."""
    if est is None:
        return None
    if isinstance(est, Estimate):
        return fn(est)
    return tuple(None if e is None else fn(e) for e in est)


# ---------------------------------------------------------------------------
# host -> device slice prefetch (streaming sources)
# ---------------------------------------------------------------------------

class _SlicePrefetcher:
    """Double-buffered host→device pipeline for streaming sources.

    One worker thread reads round-slice r+1 while the caller computes
    round r; :meth:`get` hands over slice r and schedules r+1 at once, so
    at most two slices are alive on the device.  On a CUDA device the
    worker copies the slice from the source straight into one of two
    pinned staging buffers (``ChunkSource.read_into``) and issues the
    host→device copy on a side stream, recording an event after it.  The
    caller's stream waits on that event before using the slice (no
    host-side synchronize, so copy and compute overlap), the device
    buffers are ``record_stream``-ed onto it, and a staging buffer is
    written again only after the event of the copy out of it has
    completed.  On the CPU the worker reads the slice and nothing more.

    ``stats()`` reports the bytes moved, the host seconds spent reading
    into staging, the device milliseconds of the copies (CUDA events) and
    the caller's seconds spent waiting for a slice.
    """

    def __init__(self, source: DS.ChunkSource, bounds, device: torch.device):
        self._source = source
        self._bounds = list(bounds)  # [(lo, hi)] per round
        self._dev = device
        self._ex = ThreadPoolExecutor(max_workers=1)
        self._fut = self._next_r = None
        self._cuda = device.type == "cuda"
        self._staging = [None, None]  # pinned buffers per slot
        self._copied = [None, None]  # event after the last copy out of a slot
        self._timing = []  # (start, end) events per copy
        self._fetched = self._bytes = 0
        self._read_s = 0.0
        self._wait_s = 0.0
        if self._cuda:
            self._stream = torch.cuda.Stream(device)

    def _staging_for(self, slot: int, width: int) -> dict:
        like = self._source.step_slice_like(width)
        bufs = self._staging[slot]
        if bufs is None or any(tuple(bufs[k].shape) != shape
                               for k, (shape, _) in like.items()):
            bufs = self._staging[slot] = {
                k: torch.empty(shape, dtype=ENC.torch_dtype(dt), pin_memory=True)
                for k, (shape, dt) in like.items()}
        return bufs

    def _fetch(self, r: int):
        lo, hi = self._bounds[r]
        t0 = time.perf_counter()
        self._fetched += 1
        if not self._cuda:
            out = {k: DS.as_tensor(v)
                   for k, v in self._source.slice_cols(lo, hi).items()}
            self._read_s += time.perf_counter() - t0
            self._bytes += sum(t.numel() * t.element_size() for t in out.values())
            return out, None
        slot = r % 2
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # its last copy has left the buffer
        t0 = time.perf_counter()
        bufs = self._staging_for(slot, hi - lo)
        self._source.read_into(lo, hi, {k: b.numpy() for k, b in bufs.items()})
        self._read_s += time.perf_counter() - t0
        with torch.cuda.device(self._dev), torch.cuda.stream(self._stream):
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            out = {k: b.to(self._dev, non_blocking=True) for k, b in bufs.items()}
            done.record(self._stream)
        self._copied[slot] = done
        self._timing.append((start, done))
        self._bytes += sum(b.numel() * b.element_size() for b in bufs.values())
        return out, done

    def get(self, r: int) -> dict:
        """Device tensors of round r's slice, ready for the current
        stream; the fetch of round r+1 is scheduled before this waits.

        When the read of round r fails, the fetch of r+1 already scheduled
        is drained before the error leaves: a ``PartitionLostError`` it
        raised (its source marks those partitions dead and serves them
        zeroed from then on, round r's retry included) joins the one
        raised here, so the caller records every lost partition at round
        r; a slice it read is dropped and fetched again."""
        if self._fut is not None and self._next_r == r:
            fut = self._fut
        else:
            fut = self._ex.submit(self._fetch, r)
        if r + 1 < len(self._bounds):
            self._fut, self._next_r = self._ex.submit(self._fetch, r + 1), r + 1
        else:
            self._fut = self._next_r = None
        t0 = time.perf_counter()
        try:
            out, done = fut.result()
        except DS.PartitionLostError as e:
            lost = set(e.partitions) | self._drain()
            raise DS.PartitionLostError(lost) from e
        except BaseException:
            self._drain()
            raise
        finally:
            self._wait_s += time.perf_counter() - t0
        if done is not None:
            cur = torch.cuda.current_stream(self._dev)
            cur.wait_event(done)
            for t in out.values():
                t.record_stream(cur)
        return out

    def _drain(self) -> set:
        """Cancel or wait out the scheduled fetch and forget it (a slice it
        read is fetched again); returns the partitions a
        ``PartitionLostError`` of it names.  An error of another kind
        raises here."""
        fut, self._fut, self._next_r = self._fut, None, None
        if fut is None or fut.cancel():
            return set()
        try:
            fut.result()
        except DS.PartitionLostError as e:
            return set(e.partitions)
        return set()

    def close(self) -> dict:
        """Retire the worker (waiting for a fetch in flight), free the
        staging buffers and return :meth:`stats`."""
        self._fut = self._next_r = None
        self._ex.shutdown(wait=True, cancel_futures=True)
        self._staging = [None, None]
        return self.stats()

    def stats(self) -> dict:
        copy_ms = 0.0
        for start, done in self._timing:
            done.synchronize()
            copy_ms += start.elapsed_time(done)
        return {"slices": self._fetched, "bytes": self._bytes, "read_s": self._read_s,
                "copy_ms": copy_ms if self._cuda else None,
                "wait_s": self._wait_s}


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

def session_path(gla: GLA, columns, emit: str, lanes: int) -> str:
    """The per-round path a session runs for ``gla`` over a source whose
    column table is ``columns``: ``"scan"`` unless ``emit="kernel"``, then
    ``"kernel_fused"`` (K1) whenever the fused contract can be used, else
    ``"kernel_bundle"`` or ``"kernel_group"`` (K3) or ``"kernel_scalar"``
    (K4) — the reference's routing.  ``repro_torch.audit`` certifies the
    path this returns."""
    if emit != "kernel":
        return "scan"
    if lanes != 1:
        raise ValueError("emit='kernel' runs single-lane")
    if SC.fused_available(gla, columns):
        return "kernel_fused"
    return ("kernel_bundle" if gla.members
            else "kernel_group" if gla.kernel_num_groups is not None
            else "kernel_scalar")


class Session:
    """A long-lived OLA query: advance round by round, stop early.

    ``data`` is a resident ``[P, C, L]`` shards dict or any
    :class:`repro_torch.data.source.ChunkSource`.  Resident data is moved
    to ``device`` ("cuda" by default, a no-op for tensors already there);
    a streaming source is read one prefetched round-slice at a time.
    Drive it with

      * :meth:`run` — to convergence (``stop`` rule) or completion.  With no
        stopping rule, no prior :meth:`step` and resident data this runs
        the whole-scan program of ``engine.run_query``; a streaming source
        always steps round by round.
      * :meth:`step` — one round-slice; returns the :class:`RoundProgress`
        the stopping rule saw.  Needs ``sync=False``, a partition-uniform
        schedule and no [R, P] alive schedule.
      * :meth:`result` — :class:`engine.QueryResult` over the rounds run.
      * :meth:`pause` / :meth:`resume` — checkpoint between rounds and
        continue later, bitwise, in this process or another, or on another
        partition count.

    With ``mesh`` (a :class:`repro_torch.sharded.PartitionGroup`) the
    session is this process's rank of a partition group and runs on the
    group's device: ``data`` is this rank's resident block ``[P/W, C, L]``
    or a source over the whole layout, whose partitions
    :meth:`repro_torch.sharded.PartitionGroup.bounds` gives this rank.

    ``audit=True`` (or a tuple of check names) certifies the plan with
    :func:`repro_torch.audit.audit_plan` before the first slice is read and
    raises ``AuditError`` on a failure; the report is ``audit_report``.
    """

    def __init__(self, spec, data, *, device=None, mesh=None, audit=None, **plan):
        with obs.span("pfola.session.init"):
            qspec = QS.coerce_spec(spec, plan, caller="Session")
            self._mesh = mesh
            if mesh is None:
                dev = resolve_device("cuda" if device is None else device)
                source, whole = DS.as_source(data), None
            else:
                dev = SH.resolve_device(mesh, device)
                source, whole = SH.rank_view(mesh, data)
            source = DS.place(source, dev)
            self._whole = whole or source.spec  # the whole layout's spec
            qspec = EN.normalize_plan(qspec, self._whole)
        self.spec = qspec  # the resolved plan, for introspection
        gla: GLA = qspec.gla
        self._gla = gla
        self._device = dev
        self._source = source
        self._resident = source.resident
        self._shards = source.shards if source.resident else None
        self._sched = np.asarray(qspec.schedule, np.int32)
        self._rounds = self._sched.shape[1] - 1
        self._stop = qspec.stop
        self._confidence = float(qspec.confidence)
        self._mode = qspec.mode
        self._emit = qspec.emit
        self._lanes = qspec.lanes
        self._snapshots = qspec.snapshots
        self._sync_cost_model = qspec.sync_cost_model
        P, C, L = self._whole.P, self._whole.C, self._whole.L
        self._P, self._C, self._L = P, C, L
        self._n = source.spec.P  # partitions this process steps

        alive_np = None if qspec.alive is None else np.asarray(qspec.alive)
        self._alive_np = alive_np  # as given, for the checkpoint
        self._all_alive = alive_np is None or bool(np.all(alive_np))
        self._alive = (np.ones((P,), bool) if alive_np is None else alive_np)

        fault = qspec.resolved_fault()
        self._policy = fault
        self._fail_at = {} if fault is None else dict(fault.fail_at)
        self._prefail_est = None  # the last round's Estimate before a failure
        if fault is not None:
            if alive_np is not None:
                raise ValueError(
                    "pass failures either as a static alive mask or through "
                    "a FaultPolicy, not both")
            if not gla.merge_is_additive:
                raise ValueError(
                    "FaultPolicy needs additive merges: excluding dead "
                    "partitions is a weighted merge, which non-additive "
                    "GLAs cannot honor")
            for p in self._fail_at:
                if p >= P:
                    raise ValueError(f"FaultPolicy.fail_at names partition "
                                     f"{p}, but the data has P={P}")

        uniform = bool(np.all(self._sched == self._sched[0]))
        self._incremental_ok = (self._mode == "async" and uniform
                                and self._alive.ndim == 1)
        if self._stop is not None and not self._incremental_ok:
            raise ValueError(
                "stopping rules need an incrementally-steppable session: "
                "sync=False with a partition-uniform schedule and no [R, P] "
                "failure-injection alive mask")
        if not self._resident and not self._incremental_ok:
            raise ValueError(
                "streaming sources scan incrementally and need an "
                "incrementally-steppable config: sync=False with a "
                "partition-uniform schedule and no [R, P] alive schedule "
                "(whole-scan semantics require resident shards)")
        self._path = session_path(gla, source.spec.columns, self._emit, self._lanes)
        # an encoded source ships physical columns; _step decodes them
        self._encodings = tuple(source.encodings or ())
        self._prefetch: Optional[_SlicePrefetcher] = None
        self._io_stats: Optional[dict] = None

        self._d_local = self._d_total = None
        self._w_pr = self._w_final = None
        self._mask_cum: Optional[np.ndarray] = None
        self._states: Optional[Pytree] = None
        self._views: Optional[Pytree] = None  # every partition's, gathered under a mesh
        self._merged: List[Pytree] = []
        self._ests: List[Any] = []
        self._steps = 0
        self._elapsed = 0.0
        self._converged = False
        self._fused = False  # ran the whole-scan program: nothing to pause
        self._result: Optional[EN.QueryResult] = None

        # audit=True certifies the plan against the static invariant
        # catalog (repro_torch.audit) before the first slice is read;
        # audit=("name", ...) selects checks.  A failure raises AuditError
        # here, so a bad plan never runs; the report stays on
        # ``self.audit_report`` (None without an audit).  Under a mesh every
        # rank audits together, as every rank constructs the session.
        self.audit_report = None
        if audit:
            from repro_torch import audit as AU  # audit imports session

            self.audit_report = AU.audit_plan(
                gla, source if mesh is None else SH.RankView(source, self._whole),
                rounds=self._rounds, schedule=self._sched, emit=self._emit,
                mode=self._mode, lanes=self._lanes, snapshots=self._snapshots,
                confidence=self._confidence, mesh=mesh, device=dev,
                checks=None if audit is True else tuple(audit),
                raise_on_failure=True)

    # -- introspection -------------------------------------------------------

    @property
    def steps_taken(self) -> int:
        """Round-slices executed so far (the k in 'pays only k/N')."""
        return self._steps

    @property
    def rounds_total(self) -> int:
        return self._rounds

    @property
    def converged(self) -> bool:
        """True once the stopping rule has fired."""
        return self._converged

    @property
    def done(self) -> bool:
        return (self._converged or self._steps >= self._rounds
                or self._result is not None)

    @property
    def elapsed_s(self) -> float:
        return self._elapsed

    @property
    def io_stats(self) -> Optional[dict]:
        """What the prefetcher moved (streaming sources; None when
        resident): ``bytes`` host→device, ``read_s`` host seconds reading
        into staging, ``copy_ms`` device milliseconds of the copies (CUDA
        events; None on the CPU), ``wait_s`` seconds the session waited
        for a slice.  Final once the session is done."""
        if self._prefetch is not None:
            return self._prefetch.stats()
        return self._io_stats

    # -- the incremental driver ----------------------------------------------

    def _init_states(self, n: Optional[int] = None) -> Pytree:
        """Initial states of ``n`` partitions (this process's by default)."""
        n = self._n if n is None else n
        batch = (n,) if self._path != "scan" or self._lanes == 1 else (n, self._lanes)
        return SC.stack_init(self._gla, batch, self._device)

    def _ensure_stats(self) -> None:
        if self._d_local is None:
            # per-chunk live counts from the source (host float64, exact):
            # no resident _mask needed
            counts = self._source.mask_chunk_sums()  # [P, C]
            if self._mesh is not None:  # every rank's, in partition order
                counts = self._mesh.gather(torch.from_numpy(counts)).cpu().numpy()
            self._d_local = torch.from_numpy(counts.sum(axis=1)).to(
                self._device, torch.float32)
            self._d_total = self._d_local.sum()
            self._mask_cum = np.cumsum(counts, axis=1)
            self._w_pr, self._w_final = SC.round_weights(
                self._alive, self._rounds, self._device)

    def _slice_shards(self, r: int, lo: int, hi: int) -> dict:
        """Round r's slice: lazy slicing of resident shards, a slice the
        source gathers on the device, else the prefetcher's buffers."""
        if self._resident:
            return {k: v[:, lo:hi] for k, v in self._shards.items()}
        if self._source.device_slices:
            return self._source.slice_cols(lo, hi)
        if self._prefetch is None:
            bounds = [(int(self._sched[0, i]), int(self._sched[0, i + 1]))
                      for i in range(self._rounds)]
            self._prefetch = _SlicePrefetcher(self._source, bounds, self._device)
        return self._prefetch.get(r)

    def _close_prefetch(self) -> None:
        if self._prefetch is not None:
            self._io_stats = self._prefetch.close()
            self._prefetch = None

    # -- runtime failure bookkeeping (FaultPolicy) ---------------------------

    def _record_failure(self, p: int, r: int) -> None:
        if not 0 <= p < self._P:
            raise ValueError(f"source reported lost partition {p}, but the "
                             f"data has P={self._P}")
        # the first failure round wins: a retried read re-reporting the
        # same loss must not move it
        self._fail_at.setdefault(int(p), int(r))

    def _alive_now(self, r: int) -> np.ndarray:
        """[P] bool — partition p contributes to round r's merge iff it has
        not failed at or before r (``fault.failure_schedule``'s rule)."""
        a = np.ones(self._P, bool)
        for p, fr in self._fail_at.items():
            if fr <= r:
                a[p] = False
        return a

    def _first_fail_round(self) -> Optional[int]:
        return min(self._fail_at.values()) if self._fail_at else None

    def _fetch_slice(self, r: int, lo: int, hi: int) -> dict:
        """Round r's slice, surviving partition loss when a policy is
        attached: a ``PartitionLostError`` records the partitions it names
        at round r and the read is retried (the source serves them zeroed
        from then on).  At most P+1 attempts: each retry must name a new
        partition."""
        for _ in range(self._P + 1):
            try:
                return self._slice_shards(r, lo, hi)
            except DS.PartitionLostError as e:
                if self._policy is None:
                    self._close_prefetch()  # the session cannot go on
                    raise
                for p in e.partitions:
                    self._record_failure(p, r)
        self._close_prefetch()
        raise RuntimeError(f"source kept losing partitions at round {r} — "
                           "more loss reports than partitions")

    def _apply_policy_est(self, est, r: int):
        """Round r's §4.6 estimator consequences: ``single`` passes through;
        ``multiple`` poisons the bounds from the failure round on;
        ``synchronized`` freezes at the last pre-failure round (infinite
        bounds when nothing preceded it)."""
        fr = self._first_fail_round()
        if fr is None or r < fr:
            self._prefail_est = est
            return est
        if self._policy.estimator == "single":
            return est
        if self._policy.estimator == "multiple" or self._prefail_est is None:
            return _map_member_ests(FT.poison_bounds, est)
        return self._prefail_est

    def step(self) -> RoundProgress:
        """Advance one round-slice; evaluate the stopping rule; return what
        it saw."""
        with obs.span("pfola.round", r=self._steps):
            return self._step()

    def _step(self) -> RoundProgress:
        if self._result is not None:
            raise RuntimeError("session already ran to completion")
        if not self._incremental_ok:
            raise ValueError(
                "this session cannot step incrementally (sync mode, "
                "non-uniform schedule, or [R, P] alive schedule) — use run()")
        if self.done:
            raise RuntimeError("session is done; call result()")
        t0 = time.perf_counter()
        self._ensure_stats()
        r = self._steps
        lo, hi = int(self._sched[0, r]), int(self._sched[0, r + 1])
        states = self._states if self._states is not None else self._init_states()
        first = self._path not in ("scan", "kernel_fused") and r == 0

        def advance():
            known = set(self._fail_at)
            slice_shards = self._fetch_slice(r, lo, hi)
            out = SC.round_step(self._gla, states, slice_shards, path=self._path,
                                lanes=self._lanes, first=first,
                                encodings=self._encodings)
            return out, set(self._fail_at) - known

        if self._mesh is None:
            (new_states, views), _ = advance()
        else:
            # every rank learns every rank's outcome (and losses) before
            # the round's merge
            (new_states, views), lost = SH.checked(self._mesh, self._P, advance)
            for p in lost:
                self._record_failure(p, r)
        w_r, all_alive = self._w_pr[:, r], self._all_alive
        if self._fail_at:
            alive_now = self._alive_now(r)
            if not alive_now.all():
                # dead partitions drop out of this round's merge; their
                # carry keeps stepping (weight 0 from now on)
                w_r = w_r * torch.as_tensor(alive_now, device=w_r.device)
                all_alive = False
        if self._mesh is None:
            merged, est = EN._merge_round(self._gla, views, w_r, self._d_local,
                                          self._d_total, self._confidence, all_alive)
        else:
            views, merged, est = SH.session_step_sharded(
                self._gla, views, w_r, self._d_local, self._d_total,
                mesh=self._mesh, confidence=self._confidence, all_alive=all_alive)
        if self._policy is not None:
            est = self._apply_policy_est(est, r)
        self._states, self._views = new_states, views
        if self._snapshots:
            self._merged.append(merged)
            self._ests.append(est)
        self._steps += 1
        scanned = float(self._mask_cum[:, hi - 1].sum()) if hi else 0.0
        self._elapsed += time.perf_counter() - t0
        prog = RoundProgress(
            round=self._steps, rounds_total=self._rounds, estimates=est,
            scanned=scanned, d_total=float(self._d_total),
            elapsed_s=self._elapsed)
        if self._stop is not None and (
                self._stop(prog) if self._mesh is None
                # rank 0 decides for every rank: a time budget must not
                # stop the ranks at different rounds
                else self._mesh.decide(lambda: self._stop(prog))):
            self._converged = True
        if self.done:
            self._close_prefetch()
        return prog

    def run(self) -> EN.QueryResult:
        """Drive to convergence or completion and return the result.
        Resident data with no stopping rule runs the whole-scan program;
        a streaming source always steps round by round."""
        if self._result is not None:
            return self._result
        if self._resident and self._steps == 0 and (
                self._stop is None or not self._incremental_ok):
            t0 = time.perf_counter()
            self._fused = True
            alive, all_alive = self._alive, self._all_alive
            if self._fail_at:
                # injected failures on the whole-scan program: the policy
                # as an [R, P] schedule, as fault.run_with_failures ships it
                alive = FT.failure_schedule(self._P, self._rounds, self._fail_at)
                all_alive = False
            self._result = EN._execute_full(
                self._gla, self._shards, self._sched, alive,
                mode=self._mode, emit=self._emit, lanes=self._lanes,
                snapshots=self._snapshots, confidence=self._confidence,
                all_alive=all_alive, mesh=self._mesh,
                sync_cost_model=self._sync_cost_model)
            fr = self._first_fail_round()
            post = None if fr is None or fr >= self._rounds else {
                "multiple": lambda e: FT._poison(e, fr),
                "synchronized": lambda e: FT._stall(e, fr)}.get(
                    self._policy.estimator)
            if post is not None and self._result.estimates is not None:
                self._result = self._result._replace(
                    estimates=_map_member_ests(post, self._result.estimates))
            self._elapsed += time.perf_counter() - t0
            self._steps = self._rounds
            return self._result
        while not self.done:
            self.step()
        return self.result()

    def result(self) -> EN.QueryResult:
        """QueryResult over the rounds executed so far.

        ``final`` is Terminate(Merge of the current per-partition states) —
        the full-scan answer when the session completed, the raw partial
        aggregate over the scanned prefix when it stopped early (the anytime
        *answer* is the last round's ``estimates`` entry).
        ``snapshots``/``estimates`` stack the executed rounds.
        """
        if self._result is not None:
            return self._result
        if self._steps == 0:
            raise RuntimeError("no rounds executed yet — step() or run()")
        w_final, all_alive = self._w_final, self._all_alive
        if self._fail_at:
            alive_now = self._alive_now(self._steps - 1)
            if not alive_now.all():
                # the final is over the surviving partitions' data: a dead
                # partition's carry is lost with it (§4.6)
                w_final = w_final * torch.as_tensor(alive_now, device=w_final.device)
                all_alive = False
        final = self._gla.terminate(EN._merge_over_partitions(
            self._gla, self._views, w_final, all_alive))
        snaps = tree_stack(self._merged) if self._merged else None
        ests = None
        if self._ests and self._ests[0] is not None:
            ests = tree_stack(self._ests)
        res = EN.QueryResult(final, snaps, ests, self._d_total, self._d_local)
        if self.done:
            self._result = res
        return res

    # -- pause / resume ------------------------------------------------------

    def _meta(self) -> dict:
        return {
            "version": _CKPT_VERSION, "framework": ckpt.FRAMEWORK,
            "gla": self._gla.name, "rounds": self._rounds, "steps": self._steps,
            "emit": self._emit, "mode": self._mode, "lanes": self._lanes,
            "snapshots": self._snapshots, "confidence": self._confidence,
            "path": self._path, "P": self._P, "C": self._C, "L": self._L,
            # the cursor means something only against the same round
            # boundaries and liveness weights, so both round-trip
            "schedule": self._sched.tolist(),
            "alive": (None if self._alive_np is None
                      else np.asarray(self._alive_np, int).tolist()),
            # the chunk each partition has consumed up to, the failure
            # record as [partition, round] pairs and the fault family
            "cursors": [int(self._sched[p, self._steps]) for p in range(self._P)],
            "fail_at": sorted([int(p), int(r)] for p, r in self._fail_at.items()),
            "fault_estimator": (None if self._policy is None
                                else self._policy.estimator),
            "elapsed_s": self._elapsed, "converged": self._converged,
            # resume refuses other data, same-shape data included; under a
            # mesh both are the whole layout's, as one process sees it
            "source": self._whole.meta(),
            "fingerprint": self._fingerprint(),
        }

    def _fingerprint(self) -> str:
        """The data's content fingerprint — the whole layout's, gathered
        from every rank's partitions under a mesh."""
        if self._mesh is None:
            return self._source.fingerprint()
        return SH.fingerprint(self._mesh, self._source, self._whole)

    def _payload_like(self, steps: int) -> dict:
        """The checkpoint payload's structure, rebuilt from the session's
        configuration, never from live state: the initial per-partition
        states, and the merged state and Estimate that one round over them
        gives (a few tensors of the state's size; no data is read, so it
        works for any source)."""
        self._ensure_stats()
        states = self._init_states(self._P)
        merged, est = EN._merge_round(
            self._gla, states, self._w_pr[:, 0], self._d_local, self._d_total,
            self._confidence, self._all_alive)
        hist = steps if self._snapshots else 0  # no history retained
        return {"states": states, "views": states,
                "merged": (merged,) * hist, "ests": (est,) * hist}

    def pause(self, path) -> None:
        """Checkpoint the session between rounds (Serialize, paper Table 1).

        Stores the per-partition carries, the per-round merged states and
        estimates, and the scan cursor (``repro_torch.ckpt``).  Resume with
        :meth:`Session.resume`, in this process or another: the remaining
        rounds replay the same program, so finals are bitwise the
        uninterrupted session's.

        Under a mesh every rank calls it: the ranks' carries are gathered,
        rank 0 writes the envelope a one-process pause writes (the whole
        layout's P, schedule, cursors and fingerprint; every partition's
        carries), and no rank returns before the file is written."""
        if self._fused:
            raise RuntimeError(
                "session ran the whole-scan program — there is no incremental "
                "carry to pause; attach a stopping rule or step() instead")
        self._close_prefetch()  # a paused session holds no worker thread
        states = self._states
        if self._mesh is not None and self._steps:
            states = self._mesh.gather(states)
        meta = self._meta()

        def write():
            blob = b""
            if self._steps:
                blob = ckpt.serialize_state({
                    "states": states, "views": self._views,
                    "merged": tuple(self._merged), "ests": tuple(self._ests)})
            ckpt.save_envelope(path, meta, blob)
            return None, ()

        if self._mesh is None:
            write()
        elif self._mesh.rank == 0:
            SH.checked(self._mesh, self._P, write)
        else:  # waits for rank 0's write, and fails with it
            SH.checked(self._mesh, self._P, lambda: (None, ()))

    @classmethod
    def resume(cls, path, gla: GLA, data, *, stop: Optional[StoppingRule] = None,
               partitions: Optional[int] = None,
               fault: Optional[FaultPolicy] = None, device=None,
               mesh=None) -> "Session":
        """Rebuild a paused session from ``path`` and the same GLA and data.

        The checkpoint stores configuration and state, not code or data: the
        caller supplies the same GLA and dataset (a shards dict or any
        source).  The data's content fingerprint must equal the one stored
        at pause time, so other data — same shapes included — is refused.
        Every plan mismatch (gla name, P, C, L, rounds, the estimator
        family, the data) is a ``ValueError`` naming the field, raised
        before any state is read or placed on the device.  ``stop`` is
        attached fresh: rules are closures and do not serialize.

        **Elastic resume**: ``partitions=P'`` continues on another partition
        count — P'|P merges carries (``scan.merge_carries``), P|P' splits
        them (``scan.split_carries``) — over a ``RepartitionedSource`` of
        the data with round boundaries re-derived for P'.  It needs an
        all-alive checkpoint with a partition-uniform schedule; finals
        match the uninterrupted run up to the merge's association order
        (bitwise for count-like sums).

        The failure record and estimator family come back from the
        checkpoint; ``fault`` extends them (its family must agree).
        ``synchronized`` sessions restore the frozen estimate from the
        snapshot history; with ``snapshots=False`` there is none, and
        rounds after a failure get infinite bounds.

        ``mesh`` resumes as a rank of a partition group (every rank calls
        this with the same path and its ``data``, as :class:`Session`
        takes it): each rank reads the file and keeps its own rows of the
        carries, after any merge or split.  The envelope does not record
        how many processes wrote it: one written by W ranks resumes in one
        process, on W' ranks, or on another partition count (W' must
        divide both counts).
        """
        meta, blob = ckpt.load_envelope(path)
        ckpt.require_version(meta, (_CKPT_VERSION,), what="session checkpoint")

        # -- the supplied plan against the envelope, before any device work
        if mesh is None:
            view = SH.RankView(DS.as_source(data), None)
        else:
            view = SH.rank_view(mesh, data)

        def spec_of(v):
            return v.spec or v.source.spec

        def relayout(v, P_new):
            if mesh is None:
                return SH.RankView(DS.repartition(v.source, P_new), None)
            return SH.repartition_view(v, mesh, P_new)

        src = spec_of(view)
        if meta["gla"] != gla.name:
            raise ValueError(f"checkpoint mismatch: gla was {meta['gla']!r} at "
                             f"pause time, got {gla.name!r} now")
        if meta["L"] != src.L:
            raise ValueError(f"checkpoint mismatch: L was {meta['L']!r} at "
                             f"pause time, got {src.L!r} now")
        if src.P != int(meta["P"]):
            # the data may come in its original layout while the session was
            # paused on a view of it (or the other way round)
            try:
                view = relayout(view, int(meta["P"]))
            except ValueError as err:
                raise ValueError(
                    f"checkpoint mismatch: P was {meta['P']!r} at pause time, "
                    f"got {src.P!r} now ({err})") from None
            src = spec_of(view)
        if meta["C"] != src.C:
            raise ValueError(f"checkpoint mismatch: C was {meta['C']!r} at "
                             f"pause time, got {src.C!r} now")
        sched = np.asarray(meta["schedule"], np.int32)
        if (sched.ndim != 2 or sched.shape[0] != meta["P"]
                or meta["rounds"] != sched.shape[1] - 1
                or not 0 <= meta["steps"] <= meta["rounds"]):
            raise ValueError(
                f"checkpoint mismatch: rounds {meta['rounds']!r} / steps "
                f"{meta['steps']!r} do not agree with the stored "
                f"{list(sched.shape)}-shaped schedule")
        fp = (view.source.fingerprint() if mesh is None
              else SH.fingerprint(mesh, view.source, src))
        if meta["fingerprint"] != fp:
            raise ValueError(
                "checkpoint mismatch: data content fingerprint differs — the "
                "supplied data is not what this session was paused over (same "
                "shapes are not enough; resuming would give wrong finals)")

        # -- the failure record; a supplied policy must agree on the family
        rec_fail = {int(p): int(r) for p, r in meta["fail_at"]}
        rec_est = meta["fault_estimator"]
        if fault is not None and rec_est is not None and fault.estimator != rec_est:
            raise ValueError(
                f"checkpoint mismatch: fault estimator family was {rec_est!r} "
                f"at pause time, got {fault.estimator!r} now")
        if fault is None and rec_est is not None:
            fault = FaultPolicy(rec_est, fail_at=rec_fail)
        elif fault is not None and rec_fail:
            at = dict(fault.fail_at)
            for p, r in rec_fail.items():
                at[p] = min(r, at.get(p, r))
            fault = FaultPolicy(fault.estimator, fail_at=at)
        alive = None if meta["alive"] is None else np.asarray(meta["alive"], bool)

        # -- elastic resume: the source view and schedule for P'
        P_old = int(meta["P"])
        factor, split = 1, False
        if partitions is not None and int(partitions) != P_old:
            P_new = int(partitions)
            if alive is not None or rec_fail:
                raise ValueError(
                    "elastic resume requires an all-alive checkpoint: dead "
                    "partitions' carries are lost and cannot be merged or "
                    "split into a new layout")
            bounds = sched[0]
            if not np.all(sched == bounds):
                raise ValueError("elastic resume requires a partition-uniform schedule")
            view = relayout(view, P_new)  # validates divisibility
            if P_new <= P_old:
                factor = P_old // P_new
                bounds = bounds * factor
            else:
                factor, split = P_new // P_old, True
                if np.any(bounds % factor):
                    raise ValueError(
                        f"cannot split {P_old} -> {P_new} partitions: round "
                        f"boundaries {bounds.tolist()} are not all divisible "
                        f"by {factor}")
                bounds = bounds // factor
            sched = np.broadcast_to(bounds, (P_new, bounds.size)).astype(np.int32)

        sess = cls(QS.QuerySpec(
            gla, rounds=int(sched.shape[1] - 1), stop=stop, schedule=sched,
            alive=alive, fault=fault, confidence=meta["confidence"],
            sync=meta["mode"] == "sync", emit=meta["emit"], lanes=meta["lanes"],
            snapshots=meta["snapshots"]), view if mesh else view.source,
            device=device, mesh=mesh)
        if meta["steps"]:
            # the skeleton gives the structure; shapes (the old layout's
            # carries among them) come from the blob
            payload = ckpt.deserialize_state(
                blob, sess._payload_like(meta["steps"]), device=sess._device)
            states, views = payload["states"], payload["views"]
            if factor > 1:
                xform = SC.split_carries if split else SC.merge_carries
                states, views = xform(states, factor), xform(views, factor)
            if mesh is not None:  # this rank steps its own rows; the
                # merges read every partition's views
                states = SH.device_put_carry(states, mesh=mesh)
            sess._states, sess._views = states, views
            # the history is already merged over partitions: any layout
            sess._merged = list(payload["merged"])
            sess._ests = list(payload["ests"])
            if sess._ests:
                sess._prefail_est = sess._ests[-1]
        sess._steps = meta["steps"]
        sess._elapsed = meta["elapsed_s"]
        sess._converged = meta["converged"]
        return sess
