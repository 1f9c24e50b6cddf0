"""Concurrent OLA serving — one shared scan, many queries.

Port of ``repro/serving/service.py``: many analysts submit range-aggregate
queries at any time, and all of them ride ONE cyclic scan of a dataset.

  * :class:`SharedScan` — the synchronous core.  :meth:`SharedScan.step`
    advances one round-slice over a uniform schedule, cycling ``cursor mod
    R``.  Queries attach at any round into a bank of slots and detach on
    convergence or after one full pass, without stopping the scan.  A late
    joiner's carry starts at zero on its first step, so its estimates come
    from the rounds it witnessed only: the Horvitz–Thompson scale-up
    ``d_total / scanned`` keeps them unbiased whenever it joined, and they
    are bitwise a fresh solo ``Session(emit="kernel")`` over
    :func:`witnessed_view`.
  * :class:`OLAService` — the asyncio front end: ``await
    service.submit(spec, data)`` returns a :class:`QueryHandle`; the service
    owns one scan per source fingerprint, steps it on a worker thread bound
    to the service's device, applies attach/detach between steps, and parks
    an idle scan after ``grace_s`` (the drive task ends; the scan, its
    cursor and its step plans stay for the next arrival).

The serving step (the reference's ``serve_step_vmapped``) runs each live
bank of K slots as a K-member bundle (``SlotFamily.bind``) through
``scan.round_step``: on the fused path that is one K1 ``pf_bundle`` launch
per round-slice for every 16 slots, scalar slots on its scalar grids and
group slots on its group step.  The route is :func:`scan.fused_available`,
the test ``Session`` uses; a bank that cannot take K1 runs the per-chunk
``"scan"`` path (both carry-style; the delta-style K3 path is not used).
An encoded source's slice is decoded once a step, in one ``pf_decode``
launch, for every bank (the reference hands the physical words to the
closures undecoded).  The merge and estimates are ``engine._merge_round``'s.

The reference bounds its jit cache by one entry per (bank, capacity); the
port's counterpart is the **step plan**, one per (bank, K): the K zero
carries a fresh or reclaimed slot starts from, on the device, and the path
the bank takes (:func:`serve_step_cache_sizes` counts them).  A slot's
parameters are host values its closures capture, so an attach or detach at
a fixed K builds nothing; capacity doubles, so a bank builds at most 1 +
its doublings plans.  A reclaimed slot's carry is *replaced* by zeros
before its first step, never multiplied by a 0/1 mask, which would leave
-0.0 where a carry was negative (a fresh query starts from +0.0).

``SharedScan(..., mesh=)`` (a ``repro_torch.sharded.PartitionGroup``) is the
reference's ``serve_step_sharded``: every rank builds the scan over its
partitions and makes the same attach/detach calls; each steps its own
partitions, the views are gathered and merged as in one process
(``sharded.session_step_sharded``), so every rank's estimates are bitwise
the one-process scan's, and rank 0 decides each slot's stopping rule.

``OLAService(..., mesh=)`` serves across those processes.  The reference
serves a mesh from one controller; here the ranks are processes, so rank 0
owns the arrivals.  Every rank builds the service; rank 0 takes
``submit``/``cancel``, and the others run :meth:`OLAService.follow`.  Rank 0
talks to them over one ordered channel, the group's store: record n is a
JSON object under key n (its set and get timed into the group's
``stats()``).  Before each step it posts the attach and detach operations
it applied since the last one, in order, and every follower applies them to
its own scan and steps with it.  A follower waits for the next record on
the store, not in a collective, so rank 0 may idle or park past the
group's timeout; it gives up only when no record and no heartbeat of rank
0's came for that long.
"""
from __future__ import annotations

import asyncio
import dataclasses
import functools
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import engine as EN
from repro_torch import scan as SC
from repro_torch import sharded as SH
from repro_torch._device import resolve_device
from repro_torch.data import encodings as ENC
from repro_torch.data import source as DS
from repro_torch.gla import SlotFamily, SlotParams, SlotQuery
from repro_torch.session import RoundProgress, _SlicePrefetcher
from repro_torch.spec import QuerySpec
from repro_torch.uda import tree_map

#: step plans built in this process — the reference's jit-cache entries
_PLANS_BUILT = 0


def serve_step_cache_sizes() -> int:
    """Step plans built so far in this process: what a churn check reads
    before and after a workload (the reference's jit-cache entry counts)."""
    return _PLANS_BUILT


def _degrade_rounds(C: int, rounds: int) -> int:
    """Largest r <= rounds with C % r == 0: one slice width for the whole
    cyclic scan."""
    for r in range(min(int(rounds), C), 0, -1):
        if C % r == 0:
            return r
    return 1


class _StepPlan:
    """One bank's step at capacity K: K zero carries ``[n, ...]`` on the
    device (what a fresh or reclaimed slot starts from) and the path the
    bank's bundle takes (``"kernel_fused"`` or ``"scan"``)."""

    def __init__(self, family: SlotFamily, bank: str, K: int, n: int, device,
                 path: str):
        self.path = path
        self.zeros = tuple(
            tree_map(lambda x: torch.zeros((n, *x.shape), dtype=x.dtype, device=device),
                     family.zero_slot_state(bank, device))
            for _ in range(K))


@dataclasses.dataclass
class SlotRecord:
    """One attached query's slot, progress, and outcome."""

    query: SlotQuery
    bank: str
    slot: int
    generation: int
    stop: Optional[Any] = None
    witnessed: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    scanned: float = 0.0
    estimate: Any = None  # latest per-round Estimate
    elapsed_s: float = 0.0
    done: bool = False
    converged: bool = False  # stop rule fired (vs full pass)
    detached: bool = False


class _Bank:
    """One capacity bank: host-side slot parameters and device carries.

    ``K`` is a power of two; parameter rows of detached slots hold the empty
    range (weight exactly 0).  ``generation[k]`` counts attaches to slot k,
    so a stale handle never reads a reclaimed slot's results.  ``states[k]``
    is slot k's carry ``[n, ...]`` (None until it is first stepped)."""

    def __init__(self, name: str, family: SlotFamily, n: int):
        self.name = name
        self.family = family
        self.n = n
        self.K = 1
        n_pred = len(family.pred_cols)
        self.expr = np.zeros(1, np.int32)
        self.lo = np.full((1, n_pred), np.inf, np.float32)
        self.hi = np.full((1, n_pred), -np.inf, np.float32)
        self.fresh = np.zeros(1, bool)
        self.hv = np.full(1, np.inf, np.float32)
        self.generation = np.zeros(1, np.int64)
        self.slots: List[Optional[SlotRecord]] = [None]
        self.states: list = [None]
        self.plans: Dict[int, _StepPlan] = {}  # one per capacity built
        self.stepped_ks: set = set()  # capacities actually stepped

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def doublings(self) -> int:
        return int(self.K).bit_length() - 1

    def _grow(self) -> None:
        n_pred = len(self.family.pred_cols)
        K = self.K
        self.expr = np.concatenate([self.expr, np.zeros(K, np.int32)])
        self.lo = np.concatenate([self.lo, np.full((K, n_pred), np.inf, np.float32)])
        self.hi = np.concatenate([self.hi, np.full((K, n_pred), -np.inf, np.float32)])
        self.fresh = np.concatenate([self.fresh, np.zeros(K, bool)])
        self.hv = np.concatenate([self.hv, np.full(K, np.inf, np.float32)])
        self.generation = np.concatenate([self.generation, np.zeros(K, np.int64)])
        self.slots.extend([None] * K)
        self.states.extend([None] * K)
        self.K = 2 * K

    def attach(self, q: SlotQuery, stop) -> SlotRecord:
        try:
            k = self.slots.index(None)
        except ValueError:
            self._grow()
            k = self.slots.index(None)
        expr_idx, lo, hi = self.family.slot_row(q)
        self.expr[k] = expr_idx
        self.lo[k], self.hi[k] = lo, hi
        self.hv[k] = np.inf if q.having is None else q.having
        self.fresh[k] = True
        self.generation[k] += 1
        rec = SlotRecord(query=q, bank=self.name, slot=k,
                         generation=int(self.generation[k]), stop=stop)
        self.slots[k] = rec
        return rec

    def detach(self, rec: SlotRecord) -> None:
        k = rec.slot
        if rec.detached or self.slots[k] is not rec:
            return  # stale ticket: the slot was reclaimed
        rec.detached = True
        self.slots[k] = None
        e, lo, hi = self.family.inactive_row()
        self.expr[k] = e
        self.lo[k], self.hi[k] = lo, hi
        self.hv[k] = np.inf
        # the carry stays: the next attach marks the slot fresh, and its
        # first step replaces the carry with the plan's zeros

    def params(self) -> SlotParams:
        # thresholds ride along only for having banks
        hv = self.hv if self.name.endswith(":having") else None
        return SlotParams(expr=self.expr, lo=self.lo, hi=self.hi, fresh=self.fresh,
                          hv=hv)


class SharedScan:
    """One cyclic scan over one dataset, serving many slot queries.

    ``data`` is a resident ``[P, C, L]`` shards dict or any
    ``repro_torch.data.source.ChunkSource``; resident data moves to
    ``device`` ("cuda" by default), a streaming source is read one
    prefetched round-slice at a time.  Each :meth:`step` advances one
    round-slice, cycling ``cursor mod R`` over a uniform schedule
    (``rounds`` degrades to the largest divisor of C, so every slice has
    one width).  Queries :meth:`attach` at any round (their carry starts
    fresh on the next step) and are ``done`` after witnessing all R rounds
    or when their stopping rule fires; :meth:`detach` frees the slot
    without disturbing the cursor or any other query.

    Synchronous and single-threaded: :class:`OLAService` serializes
    attach/detach against the steps.  With ``mesh`` every rank builds the
    scan over ``data`` as ``Session`` takes it (its own block, or a source
    over the whole layout) and makes the same calls in the same order.
    """

    def __init__(self, family: SlotFamily, data, *, rounds: int = 8,
                 confidence: float = 0.95, mesh=None, device=None):
        self.family = family
        self.confidence = float(confidence)
        self.mesh = mesh
        if mesh is None:
            dev = resolve_device("cuda" if device is None else device)
            source, whole = DS.as_source(data), None
        else:
            dev = SH.resolve_device(mesh, device)
            source, whole = SH.rank_view(mesh, data)
        self.device = dev
        self.source = DS.place(source, dev)
        spec = whole or source.spec  # the whole layout's
        self.P, self.C = spec.P, spec.C
        self.rounds = _degrade_rounds(self.C, rounds)
        self.width = self.C // self.rounds
        ms = self.source.mask_chunk_sums()  # [n, C], host float64
        if mesh is not None:  # every rank's, in partition order
            ms = mesh.gather(torch.from_numpy(ms)).cpu().numpy()
        self._ms = ms
        self._d_local = torch.from_numpy(ms.sum(axis=1)).to(dev, torch.float32)
        self._d_total = self._d_local.sum()
        self.d_total = float(self._d_total)  # what every slot's GLA scales by
        self._w_r = torch.ones((self.P,), dtype=torch.float32, device=dev)
        self._columns = self.source.spec.columns
        self._encodings = tuple(self.source.encodings or ())
        self._prefetch: Optional[_SlicePrefetcher] = None
        self.banks: Dict[str, _Bank] = {}
        self.cursor = 0
        self.steps_done = 0

    # -- membership ---------------------------------------------------------

    @property
    def active_slots(self) -> int:
        return sum(b.active for b in self.banks.values())

    def attach(self, q: SlotQuery, stop=None) -> SlotRecord:
        name = self.family.bank_of(q)
        bank = self.banks.get(name)
        if bank is None:
            bank = self.banks[name] = _Bank(name, self.family, self.source.spec.P)
        return bank.attach(q, stop)

    def detach(self, rec: SlotRecord) -> None:
        bank = self.banks.get(rec.bank)
        if bank is not None:
            bank.detach(rec)

    def compile_budget(self) -> int:
        """Step plans this scan's workload is allowed to have built: one per
        (bank, capacity) actually stepped — at most 1 + doublings per
        stepped bank, never one per arrival.  What a churn check holds
        :func:`serve_step_cache_sizes`' growth to."""
        return sum(len(b.stepped_ks) for b in self.banks.values())

    # -- the drive ----------------------------------------------------------

    def step_inputs(self, name: str):
        """Bank ``name``'s next step: ``(bundle GLA, carries, path)``.  The
        carries of fresh slots (and of slots never stepped) are the plan's
        zeros; the step plan for the bank's current K is built here once."""
        global _PLANS_BUILT
        bank = self.banks[name]
        params = bank.params()
        gla = self.family.bind(name, params, self.d_total)
        plan = bank.plans.get(bank.K)
        if plan is None:
            path = ("kernel_fused" if SC.fused_available(gla, self._columns)
                    else "scan")
            plan = bank.plans[bank.K] = _StepPlan(self.family, name, bank.K, bank.n,
                                                  self.device, path)
            _PLANS_BUILT += 1
        states = tuple(z if params.fresh[k] or st is None else st
                       for k, (st, z) in enumerate(zip(bank.states, plan.zeros)))
        return gla, states, plan.path

    def _slice(self, r: int, lo: int, hi: int) -> dict:
        src = self.source
        if src.resident:
            return {k: v[:, lo:hi] for k, v in src.shards.items()}
        if src.device_slices:
            return src.slice_cols(lo, hi)
        if self._prefetch is None:
            bounds = [(i * self.width, (i + 1) * self.width) for i in range(self.rounds)]
            self._prefetch = _SlicePrefetcher(src, bounds, self.device)
        return self._prefetch.get(r)

    def _stops(self, rule, prog: RoundProgress) -> bool:
        if self.mesh is None:
            return bool(rule(prog))
        # rank 0 decides for every rank: a time budget must not stop the
        # ranks at different rounds
        return self.mesh.decide(lambda: rule(prog))

    def step(self) -> List[Tuple[SlotRecord, RoundProgress]]:
        """Advance every bank with live queries one round-slice; return the
        (record, progress) of each slot that witnessed the round.  Completed
        slots come back with ``done`` set — the caller detaches them."""
        t0 = time.perf_counter()
        r = self.cursor % self.rounds
        lo, hi = r * self.width, (r + 1) * self.width
        live = [b for b in self.banks.values() if b.active]
        if not live:
            return []
        inputs = {b.name: self.step_inputs(b.name) for b in live}

        def advance():
            cols = self._slice(r, lo, hi)
            if self._encodings:  # one decode launch for every bank
                cols = ENC.decode_cols(cols, self._encodings)
            return {name: SC.round_step(gla, states, cols, path=path, lanes=1,
                                        first=False)
                    for name, (gla, states, path) in inputs.items()}, ()

        if self.mesh is None:
            stepped, _ = advance()
        else:  # one rank's failure stops every rank at once
            stepped, _ = SH.checked(self.mesh, self.P, advance)
        range_count = float(self._ms[:, lo:hi].sum())
        out: List[Tuple[SlotRecord, RoundProgress]] = []
        for bank in live:
            gla = inputs[bank.name][0]
            new_states, views = stepped[bank.name]
            if self.mesh is None:
                _, est = EN._merge_round(gla, views, self._w_r, self._d_local,
                                         self._d_total, self.confidence, True)
            else:
                _, _, est = SH.session_step_sharded(
                    gla, views, self._w_r, self._d_local, self._d_total,
                    mesh=self.mesh, confidence=self.confidence, all_alive=True)
            bank.states = list(new_states)
            bank.fresh[:] = False
            bank.stepped_ks.add(bank.K)
            dt = time.perf_counter() - t0
            for k, rec in enumerate(bank.slots):
                if rec is None:
                    continue
                rec.witnessed.append((lo, hi))
                rec.scanned += range_count
                rec.estimate = est[k]
                rec.elapsed_s += dt
                prog = RoundProgress(
                    round=len(rec.witnessed), rounds_total=self.rounds,
                    estimates=est[k], scanned=rec.scanned, d_total=self.d_total,
                    elapsed_s=rec.elapsed_s)
                if rec.stop is not None and self._stops(rec.stop, prog):
                    rec.converged = True
                if rec.converged or len(rec.witnessed) >= self.rounds:
                    rec.done = True
                out.append((rec, prog))
        self.cursor += 1
        self.steps_done += 1
        return out

    @property
    def io_stats(self) -> Optional[dict]:
        """What the prefetcher moved so far (a streaming source; None
        otherwise): ``session.Session.io_stats``'s fields."""
        return None if self._prefetch is None else self._prefetch.stats()

    def close(self) -> None:
        """Retire the prefetcher's worker thread (a streaming source); the
        next step starts a new one."""
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None


def witnessed_view(data, ranges) -> dict:
    """The chunk ranges a slot witnessed, concatenated in witness order, as
    a fresh ``[P, C', L]`` shards dict of logical columns (an encoded
    source's are decoded) — the data a solo ``Session`` must scan to give
    the slot's estimates bitwise.  ``data`` is a shards dict or a source
    over the whole layout; tensors stay where the source keeps them."""
    src = DS.as_source(data)
    parts = [src.slice_cols(lo, hi) for lo, hi in ranges]
    cols = {k: torch.cat([DS.as_tensor(p[k]) for p in parts], dim=1) for k in parts[0]}
    return ENC.decode_cols(cols, src.encodings) if src.encodings else cols


# ---------------------------------------------------------------------------
# the asyncio service
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QueryOutcome:
    """What :meth:`QueryHandle.result` resolves to."""

    estimate: Any  # final witnessed-rounds Estimate (on the CPU)
    rounds_witnessed: int
    scanned: float
    d_total: float
    converged: bool  # stop rule fired (False = full pass)
    elapsed_s: float


def _on_cpu(tree):
    return tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, tree)


class QueryHandle:
    """An in-flight serving query: progress stream + awaitable result."""

    def __init__(self, query: SlotQuery, stop):
        self.query = query
        self._stop = stop
        self.progress: List[RoundProgress] = []
        self._done = asyncio.Event()
        self._outcome: Optional[QueryOutcome] = None
        self._error: Optional[BaseException] = None
        self._record: Optional[SlotRecord] = None
        self._cancelled = False

    @property
    def done(self) -> bool:
        return self._done.is_set()

    async def result(self) -> QueryOutcome:
        """The outcome once the query converges or completes its pass; the
        step's exception if a step of its scan failed."""
        await self._done.wait()
        if self._error is not None:
            raise self._error
        assert self._outcome is not None
        return self._outcome

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._done.set()

    def _finish(self, rec: SlotRecord, d_total: float) -> None:
        est = None if rec.estimate is None else _on_cpu(rec.estimate)
        self._outcome = QueryOutcome(
            estimate=est, rounds_witnessed=len(rec.witnessed), scanned=rec.scanned,
            d_total=d_total, converged=rec.converged, elapsed_s=rec.elapsed_s)
        self._done.set()


def _service_device(device) -> torch.device:
    """``device`` resolved, a CUDA device with its index: the card the
    service's worker thread is bound to (the current one for "cuda")."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


#: what a record of rank 0's tells its followers: build the scan, apply its
#: operations and step, apply them and stop, or stop with rank 0's error
_OPEN, _STEP, _CLOSE, _FAIL = "open", "step", "close", "fail"
_POLL_S = 0.001  # seconds between a follower's looks for the next record
_LOOK_S = 0.1  # seconds between its looks at rank 0's heartbeat


def _rank0_decides(prog) -> bool:
    """A follower's stand-in for a slot's stopping rule: ``SharedScan``
    asks ``mesh.decide``, which evaluates the rule on rank 0 alone."""
    raise RuntimeError("a stopping rule is evaluated on rank 0 alone")


def _use_device(device: torch.device) -> None:
    """The serving worker thread's initializer: its kernels go to the
    service's card, not to card 0."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


class OLAService:
    """Asyncio OLA serving over shared scans.

    One service owns one :class:`repro_torch.gla.SlotFamily` and one
    :class:`SharedScan` per source fingerprint, on ``device`` ("cuda" by
    default).  ``submit`` attaches a query to the matching scan — starting
    or un-parking it as needed — and returns a :class:`QueryHandle` whose
    ``result()`` resolves when the query converges (stop rule) or completes
    a full pass.  Convergence detaches the slot; the scan keeps running for
    the others and parks ``grace_s`` seconds after the last one leaves.

    Every step runs on one worker thread (bound to ``device``); all scan
    mutation happens on the event loop between steps, so the scans need no
    locking.

    With ``mesh`` (a ``repro_torch.sharded.PartitionGroup`` built by
    ``init_partition_group``) every rank of the group builds the service
    with the same arguments.  Rank 0 serves: ``submit``, ``cancel``,
    ``scan_for``, ``is_parked`` and ``close`` run there, over one dataset
    (its share, as ``SharedScan(mesh=)`` takes it); every other rank calls
    :meth:`follow` with its share of the same data.  The scan is a
    ``SharedScan(mesh=)`` on every rank, so estimates are bitwise the
    one-process scan's; a step that raises on any rank fails rank 0's
    queries with its error and ends every ``follow``.  ``op_log`` holds
    the (``steps_done``, operation) pairs rank 0 sent or a follower applied.
    """

    def __init__(self, family: SlotFamily, *, rounds: int = 8,
                 confidence: float = 0.95, grace_s: float = 0.25, mesh=None,
                 device=None):
        self.family = family
        self.rounds = rounds
        self.confidence = confidence
        self.grace_s = grace_s
        self.mesh = mesh
        self.op_log: List[Tuple[int, dict]] = []
        if mesh is None:
            self.device = _service_device(device)
        else:
            if mesh.store is None:
                raise ValueError("OLAService(mesh=...) needs the store the group's ranks "
                                 "met through: build the group with init_partition_group")
            self.device = _service_device(SH.resolve_device(mesh, device))
            # this service's store keys: every rank builds its services in
            # the same order, so its own count of them names the same space
            count = mesh.store.add(f"repro_torch.serve/built/{mesh.rank}", 1)
            self._keys = f"repro_torch.serve/{count}/"
            self._records = 0  # records posted (rank 0) or read (a follower)
            self._ended = False  # rank 0 posted its last record
            self._quiet = threading.Event()  # set: rank 0's heartbeat stops
            if mesh.rank == 0:
                threading.Thread(target=self._beat, name="ola-serve-beat",
                                 daemon=True).start()
        self._runners: Dict[str, "_Runner"] = {}
        #: id(shards dict) -> (the dict, its source): a dict is wrapped and
        #: fingerprinted once, not on every submit (the dict is held, so its
        #: id is not reused while the service lives)
        self._wrapped: Dict[int, Tuple[dict, DS.ChunkSource]] = {}
        self._closed = False
        self._executor: Optional[ThreadPoolExecutor] = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ola-serve", initializer=_use_device,
            initargs=(self.device,))

    # -- public surface -----------------------------------------------------

    def _source(self, data) -> DS.ChunkSource:
        """``data`` as a source whose fingerprint is computed once: a
        source caches its own; a shards dict is wrapped once per dict
        object, so it must not change while the service serves it."""
        if not isinstance(data, dict):
            return DS.as_source(data)
        hit = self._wrapped.get(id(data))
        if hit is None:
            hit = self._wrapped[id(data)] = (data, DS.as_source(data))
        return hit[1]

    async def submit(self, spec, data) -> QueryHandle:
        """Attach one slot query.  ``spec`` is a
        :class:`repro_torch.spec.QuerySpec` whose ``gla`` is a
        :class:`repro_torch.gla.SlotQuery` (its ``stop`` rule is honored;
        ``rounds`` is scan-wide, set on the service), or a bare
        ``SlotQuery``."""
        self._rank0_only("submit")
        if self._closed:
            raise RuntimeError("service is closed")
        if isinstance(spec, QuerySpec):
            query, stop = spec.gla, spec.stop
            if spec.confidence != self.confidence:
                raise ValueError(
                    f"per-query confidence {spec.confidence} != service "
                    f"confidence {self.confidence}: confidence is a "
                    "compile-time static of the shared step — set it on "
                    "OLAService(...)")
        elif isinstance(spec, SlotQuery):
            query, stop = spec, None
        else:
            raise TypeError(
                "submit() takes a SlotQuery or a QuerySpec wrapping one, "
                f"got {type(spec).__name__}")
        if not isinstance(query, SlotQuery):
            raise TypeError(
                f"QuerySpec.gla must be a SlotQuery here, got "
                f"{type(query).__name__}")
        self.family.bank_of(query)  # an unknown group, expression or column
        self.family.slot_row(query)  # raises here, before any rank sees it
        src = self._source(data)
        key = src.fingerprint()
        runner = self._runners.get(key)
        if runner is None:
            if self.mesh is None:
                scan = SharedScan(self.family, src, rounds=self.rounds,
                                  confidence=self.confidence, device=self.device)
            elif self._runners:
                raise ValueError("a service over a mesh serves one dataset: its "
                                 "followers scan their shares of the data of its "
                                 "first submit")
            else:  # the followers build their scans with this one
                self._post(_OPEN)
                scan = SharedScan(self.family, data, rounds=self.rounds,
                                  confidence=self.confidence, mesh=self.mesh)
            runner = self._runners[key] = _Runner(scan)
        handle = QueryHandle(query, stop)
        runner.pending.append(("attach", handle))
        runner.wake.set()
        if runner.task is None or runner.task.done():
            runner.task = asyncio.get_running_loop().create_task(self._drive(runner))
        return handle

    def cancel(self, handle: QueryHandle) -> None:
        """Detach a query before it converges; its handle resolves with
        whatever it had witnessed so far."""
        self._rank0_only("cancel")
        handle._cancelled = True
        for runner in self._runners.values():
            if handle in runner.handles.values() or any(
                    h is handle for _, h in runner.pending):
                runner.pending.append(("detach", handle))
                runner.wake.set()
                return

    def scan_for(self, data) -> Optional[SharedScan]:
        """The shared scan serving ``data``, if one exists (parked or
        running)."""
        self._rank0_only("scan_for")
        runner = self._runners.get(self._source(data).fingerprint())
        return runner.scan if runner is not None else None

    def is_parked(self, data) -> bool:
        self._rank0_only("is_parked")
        runner = self._runners.get(self._source(data).fingerprint())
        return runner is not None and (runner.task is None or runner.task.done())

    async def close(self) -> None:
        """Cancel the drive tasks, then retire the scans' prefetchers and
        the worker thread (after any step it is still running); over a
        mesh, end the followers' :meth:`follow` first."""
        self._rank0_only("close")
        self._closed = True
        tasks = [r.task for r in self._runners.values()
                 if r.task is not None and not r.task.done()]
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        ex, self._executor = self._executor, None
        if ex is not None:
            await asyncio.get_running_loop().run_in_executor(ex, self._retire)
            ex.shutdown(wait=True)

    def _retire(self) -> None:
        """On the worker thread, after any step still running: the last
        record to the followers, then the scans' prefetchers."""
        runners = list(self._runners.values())
        if self.mesh is not None:
            if not self._ended:
                self._post(_CLOSE, [op for r in runners for op in r.outbox])
            self._quiet.set()
        for r in runners:
            r.scan.close()

    async def __aenter__(self) -> "OLAService":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- serving over a mesh: rank 0's messages, a follower's loop -----------

    def _rank0_only(self, what: str) -> None:
        if self.mesh is not None and self.mesh.rank != 0:
            raise RuntimeError(
                f"{what}() runs on rank 0 of a service over a mesh; rank "
                f"{self.mesh.rank} runs follow(data), which applies rank 0's "
                "attach and detach operations and steps with it")

    def _post(self, then: str, ops=(), **extra) -> None:
        """Rank 0's next record to the followers: ``ops`` to apply, then
        what to do (``_OPEN``, ``_STEP``, ``_CLOSE`` or ``_FAIL``)."""
        record = json.dumps({"ops": list(ops), "then": then, **extra}).encode()
        self.mesh.post(self._keys + str(self._records), record)
        self._records += 1
        self._ended = then in (_CLOSE, _FAIL)

    def _post_step(self, runner: "_Runner"):
        """On the worker thread: rank 0's operations since its last record
        and a step, posted to every follower, then the step's progress."""
        ops, runner.outbox = runner.outbox, []
        self._post(_STEP, ops)
        return runner.scan.step()

    def _beat(self) -> None:
        """Rank 0's heartbeat while its service is open, four a group
        timeout: a follower waiting for a record gives up only when no beat
        came for a whole timeout."""
        while not self._quiet.wait(self.mesh.timeout / 4):
            self.mesh.store.add(self._keys + "beat", 1)

    def _next_record(self) -> dict:
        """A follower's wait for rank 0's next record.  It looks at the
        store, not a collective, so an idle rank 0 never times it out; a
        rank 0 that is gone (no record and no heartbeat for the group's
        timeout) raises ``TimeoutError``."""
        mesh, key = self.mesh, self._keys + str(self._records)
        self._records += 1
        seen, since = None, time.monotonic()
        looked = since
        while not mesh.store.check([key]):
            time.sleep(_POLL_S)
            now = time.monotonic()
            if now - looked < _LOOK_S:
                continue
            looked, beat = now, mesh.store.add(self._keys + "beat", 0)
            if beat != seen:
                seen, since = beat, now
            elif now - since > mesh.timeout:
                raise TimeoutError(f"rank 0 of the service sent no record and no "
                                   f"heartbeat for {mesh.timeout} s")
        return json.loads(mesh.fetch(key))

    def follow(self, data) -> None:
        """A follower's side of a service over a mesh, on every rank but 0:
        ``data`` is this rank's share of the data rank 0 serves (as
        ``SharedScan(mesh=)`` takes it).  Builds this rank's scan when rank
        0 builds its own, applies rank 0's operations in its order and steps
        with it — detaching, as rank 0 does, every slot a step completes —
        until rank 0 closes its service.  Blocks; raises what a failed step
        raised, a ``RuntimeError`` with rank 0's error when its service
        failed outside a step, or ``TimeoutError`` when rank 0 is gone."""
        mesh = self.mesh
        if mesh is None or mesh.rank == 0:
            raise RuntimeError("follow() runs on the ranks other than 0 of a "
                               "service over a mesh")
        scan, recs = None, {}
        try:
            while True:
                msg = self._next_record()
                if msg["then"] == _FAIL:
                    raise RuntimeError(f"rank 0's service failed: {msg['error']}")
                if msg["then"] == _OPEN:
                    scan = SharedScan(self.family, data, rounds=self.rounds,
                                      confidence=self.confidence, mesh=mesh)
                    continue
                for op in msg["ops"]:
                    self.op_log.append((scan.steps_done, op))
                    if op["op"] == "attach":
                        expr, ranges, group, having = op["query"]
                        q = SlotQuery(expr, {k: tuple(v) for k, v in ranges.items()},
                                      group, having)
                        recs[op["id"]] = scan.attach(q, _rank0_decides if op["stop"] else None)
                    else:
                        scan.detach(recs.pop(op["id"]))
                if msg["then"] == _CLOSE:
                    return
                for rec, _ in scan.step():
                    if rec.done:
                        scan.detach(rec)
        finally:
            if scan is not None:
                scan.close()

    # -- the drive loop -----------------------------------------------------

    def _log(self, runner: "_Runner", op: dict) -> None:
        """Over a mesh: an operation rank 0 applied, for its next record."""
        if self.mesh is not None:
            runner.outbox.append(op)
            self.op_log.append((runner.scan.steps_done, op))

    def _apply_pending(self, runner: "_Runner") -> None:
        d_total = runner.scan.d_total
        while runner.pending:
            self._apply(runner, *runner.pending[0], d_total)
            # dropped once applied: the handle of an operation that raised
            # stays queued, so the drive loop fails it with the error
            del runner.pending[0]

    def _apply(self, runner: "_Runner", op: str, handle: QueryHandle,
               d_total: float) -> None:
        if op == "attach":
            if handle._cancelled:
                handle._finish(SlotRecord(handle.query, "", -1, 0), d_total)
                return
            q = handle.query
            rec = runner.scan.attach(q, handle._stop)
            handle._record = rec
            runner.handles[id(rec)] = handle
            n = runner.ids[id(rec)] = runner.next_id
            runner.next_id += 1
            self._log(runner, {
                "op": "attach", "id": n, "stop": handle._stop is not None,
                "query": [q.expr, {k: [float(a), float(b)] for k, (a, b) in q.ranges.items()},
                          q.group, None if q.having is None else float(q.having)]})
        else:  # detach
            rec = handle._record
            if rec is not None and not rec.detached:
                runner.scan.detach(rec)
                runner.handles.pop(id(rec), None)
                handle._finish(rec, d_total)
                self._log(runner, {"op": "detach", "id": runner.ids.pop(id(rec))})

    async def _drive(self, runner: "_Runner") -> None:
        try:
            await self._drive_steps(runner)
        except Exception as err:  # a failed step must not leave its queries waiting
            for handle in [*runner.handles.values(), *(h for _, h in runner.pending)]:
                handle._fail(err)
            runner.handles.clear()
            runner.pending.clear()
            if self.mesh is not None:  # every follower stops too: with the
                self._closed = True  # step, when it raised on every rank, or here
                self._post(_FAIL, error=f"{type(err).__name__}: {err}")

    async def _drive_steps(self, runner: "_Runner") -> None:
        loop = asyncio.get_running_loop()
        while True:
            self._apply_pending(runner)
            if runner.scan.active_slots == 0:
                runner.wake.clear()
                if runner.pending:
                    continue
                try:
                    await asyncio.wait_for(runner.wake.wait(), self.grace_s)
                except asyncio.TimeoutError:
                    return  # park: the scan object stays warm
                continue
            step = (runner.scan.step if self.mesh is None
                    else functools.partial(self._post_step, runner))
            progressed = await loop.run_in_executor(self._executor, step)
            for rec, prog in progressed:
                handle = runner.handles.get(id(rec))
                if handle is not None:
                    handle.progress.append(prog)
                if rec.done:
                    runner.scan.detach(rec)  # as every follower does
                    runner.ids.pop(id(rec), None)
                    if runner.handles.pop(id(rec), None) is not None:
                        handle._finish(rec, runner.scan.d_total)
            # yield so submit()/cancel() callbacks enqueue between steps
            await asyncio.sleep(0)


class _Runner:
    """One shared scan's drive state: the scan, its (possibly parked) task,
    queued attach/detach ops, and the record -> handle map; over a mesh
    also each record's operation id and the operations not yet posted."""

    def __init__(self, scan: SharedScan):
        self.scan = scan
        self.task: Optional[asyncio.Task] = None
        self.pending: List[Tuple[str, QueryHandle]] = []
        self.wake = asyncio.Event()
        self.handles: Dict[int, QueryHandle] = {}
        self.ids: Dict[int, int] = {}
        self.next_id = 0
        self.outbox: List[dict] = []
