"""The PF-OLA execution engine — port of ``repro/core/engine.py:58-446``.

Execution model (paper §3.2–§3.4):

  * a *partition* is the unit of data locality; partitions are the leading
    axis of the ``[P, C, L]`` shards, and every scan runs all of them at
    once (the reference ``vmap``s them; here the batch axis is written out,
    and a kernel launch covers every partition).
  * within a partition chunks are consumed in order; ``lanes > 1`` keeps
    several GLA states per partition and merges them on demand.
  * a *snapshot* is the scan carry at a round boundary — emission adds no
    recompute and no extra pass over the data.
  * a ``schedule`` gives each partition its own cumulative chunk progress;
    async snapshots take each partition at its own progress (valid for the
    single estimator under global randomization), ``sync=True`` truncates
    every partition to the global minimum (the Wu et al. barrier).
  * node failure: ``alive`` masks partitions out of merging
    (``repro_torch.fault`` builds the masks and applies each estimation
    model's consequences).
  * :func:`straggler_schedule` gives partitions heterogeneous speeds.
  * :func:`run_queries` runs N queries over ONE pass of the shards as a
    :func:`repro_torch.gla.GLABundle` and unbundles the results.
  * ``mesh=`` (``repro_torch.sharded``) runs the partitions across
    processes: each rank scans its own (:func:`_scan_states`) and the
    merge (:func:`_merge_result`) runs over every rank's states, gathered.

``emit="kernel"`` routes as the reference does: the fused kernels (K1, K2)
whenever ``scan.fused_available``; otherwise a group-by GLA or a bundle
takes one K3 launch per round-slice and a scalar GLA one K4 launch.
"""
from __future__ import annotations

import warnings
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch import scan as SC
from repro_torch import spec as QS
from repro_torch.uda import GLA, Estimate, tree_map

Pytree = Any


class QueryResult(NamedTuple):
    final: Any  # gla.terminate(fully merged state)
    snapshots: Optional[Pytree]  # merged per-round states, leaves [R, ...]
    estimates: Optional[Estimate]  # per-round Estimate, leaves [R, ...]
    d_total: torch.Tensor
    d_local: torch.Tensor  # [P]


def uniform_schedule(num_partitions: int, num_chunks: int, rounds: int) -> np.ndarray:
    """Cumulative chunk boundaries [P, R+1]; round r covers [b[r], b[r+1])."""
    b = np.round(np.linspace(0, num_chunks, rounds + 1)).astype(np.int32)
    return np.broadcast_to(b, (num_partitions, rounds + 1)).copy()


def straggler_schedule(num_partitions: int, num_chunks: int, rounds: int,
                       speeds, seed: int = 0) -> np.ndarray:
    """Per-partition progress curves under heterogeneous speeds — the
    reference's (same ``default_rng(seed)`` draws, same schedule).

    ``speeds[p]`` is partition p's relative throughput; progress accrues
    proportionally with small multiplicative jitter, capped at num_chunks.
    Every partition finishes in the last round, so the query completes:
    stragglers only delay, as in the paper's asynchronous model.
    """
    rng = np.random.default_rng(seed)
    speeds = np.asarray(speeds, np.float64)
    base = num_chunks / speeds.max()
    sched = np.zeros((num_partitions, rounds + 1), np.int32)
    for p in range(num_partitions):
        jitter = rng.uniform(0.85, 1.15, rounds)
        inc = speeds[p] * base / rounds * jitter
        cum = np.minimum(np.cumsum(inc), num_chunks)
        sched[p, 1:] = np.round(cum).astype(np.int32)
    sched[:, -1] = num_chunks  # completion
    return sched


# ---------------------------------------------------------------------------
# merges over the partition axis
# ---------------------------------------------------------------------------

def _weighted_sum(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_p w[p, ...] * x[p, ...] over the leading axis."""
    w = w.to(device=x.device, dtype=x.dtype)
    return (w.reshape(*w.shape, *([1] * (x.ndim - w.ndim))) * x).sum(dim=0)


def _merge_over_partitions(gla: GLA, states: Pytree, w: torch.Tensor,
                           all_alive: bool):
    """Merge states with leading partition axis [P, ...] under weights [P]."""
    if gla.merge_is_additive:
        return tree_map(lambda x: _weighted_sum(w, x), states)
    if not all_alive:
        raise NotImplementedError("alive masks need merge_is_additive")
    return SC.fold_merge(gla.merge, states, w.shape[0])


def _merge_rounds(gla: GLA, states: Pytree, w_pr: torch.Tensor, merge,
                  all_alive: bool):
    """Merge [P, R, ...] states with per-(partition, round) weights [P, R]."""
    if gla.merge_is_additive:
        return tree_map(lambda x: _weighted_sum(w_pr, x), states)
    if not all_alive:
        raise NotImplementedError("alive masks need merge_is_additive")
    return SC.fold_merge(merge, states, w_pr.shape[0])


def _gather_rounds(prefixes: Pytree, idx: torch.Tensor) -> Pytree:
    """prefixes leaves [P, C+1, ...] at per-partition chunk counts idx [P, R]."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return tree_map(lambda x: x[rows, idx], prefixes)


def _merge_round(gla: GLA, views, w_r: torch.Tensor, d_local: torch.Tensor,
                 d_total: torch.Tensor, confidence: float, all_alive: bool):
    """One round's merge over every partition's views [P, ...]:
    EstimatorTerminate per partition with its |D_i|, EstimatorMerge under
    the round's weights [P], and the round's Estimate (None without an
    estimation model).  Returns (merged, estimate)."""
    with obs.span("pfola.merge"):
        term = gla.estimator_terminate(views, {"d_local": d_local})
        merged = _merge_rounds(gla, tree_map(lambda x: x[:, None], term), w_r[:, None],
                               gla.estimator_merge, all_alive)
        merged = tree_map(lambda x: x[0], merged)
        est = None
        if gla.estimate is not None:
            with obs.span("pfola.estimate"):
                est = gla.estimate(merged, confidence, {"d_total": d_total})
    return merged, est


def _scan_states(gla: GLA, shards: dict, sched: np.ndarray, *, lo: int = 0,
                 mode: str, emit: str, lanes: int, snapshots: bool,
                 on_chunk=None):
    """The per-partition half of the whole-scan program, over the
    partitions ``shards`` holds — rows [lo, lo+n) of the [P, R+1]
    schedule ``sched`` (all of them in one process; one rank's share
    under ``repro_torch.sharded``).  The sync barrier truncates to the
    minimum progress over every row of ``sched``.  ``on_chunk`` is
    ``scan.scan_prefix``'s per-chunk hook.  Returns (final states
    [n, ...], round states [n, R, ...] or None, d_local [n])."""
    mask = shards["_mask"]
    dev = mask.device
    n = mask.shape[0]
    R = sched.shape[1] - 1
    d_local = SC._live(mask)
    kernel = emit == "kernel"
    if kernel and lanes != 1:
        raise ValueError("emit='kernel' runs single-lane")

    round_states = None
    # the fused kernels take [P, C, L] columns: trailing dims route to the
    # legacy kernels, as in the reference
    fused_ok = SC.fused_available(gla) and all(v.ndim == 3 for v in shards.values())
    if kernel and (gla.kernel_num_groups is not None or gla.members):
        # group and bundle states follow the round emission discipline: one
        # launch per round-slice (one for the whole scan without snapshots)
        if mode == "sync":
            raise NotImplementedError("sync mode requires emit='chunk'")
        R_ = R if snapshots else 1
        if fused_ok:
            finals, round_states = SC.fused_rounds_states(gla, shards, R_)
        elif gla.members:
            finals, round_states = SC.bundle_kernel_rounds_states(gla, shards, R_)
        else:
            finals, round_states = SC.kernel_rounds_states(gla, shards, R_)
    elif emit in ("chunk", "kernel"):
        if not kernel:
            finals, prefixes = SC.scan_prefix(gla, shards, lanes, on_chunk=on_chunk)
        elif fused_ok:
            finals, prefixes = SC.fused_prefix_states(gla, shards)
        else:
            finals, prefixes = SC.kernel_prefix_states(gla, shards)
        if snapshots:
            idx = sched[lo:lo + n, 1:]
            if mode == "sync":
                idx = np.broadcast_to(sched[:, 1:].min(axis=0), idx.shape)
            idx = torch.as_tensor(np.ascontiguousarray(idx), dtype=torch.int64,
                                  device=dev)
            round_states = _gather_rounds(prefixes, idx)  # [n, R, ...]
    elif emit == "round":
        if mode == "sync":
            raise NotImplementedError("sync mode requires emit='chunk'")
        finals, round_states = SC.scan_rounds(gla, shards, lanes, R)
    elif emit == "round_masked":  # as the reference: no sync barrier here
        finals, round_states = SC.scan_rounds_masked(gla, shards, sched[lo:lo + n],
                                                     lanes)
    else:
        raise ValueError(f"unknown emit: {emit!r}")
    return finals, round_states, d_local


def _merge_result(gla: GLA, finals, round_states, d_local: torch.Tensor, alive,
                  *, rounds: int, snapshots: bool, confidence: float,
                  all_alive: bool) -> QueryResult:
    """The merging half of the whole-scan program, over every partition's
    final and round states (leaves [P, ...] and [P, R, ...])."""
    with obs.span("pfola.merge"):
        d_total = d_local.sum()
        w_pr, w_final = SC.round_weights(alive, rounds, d_local.device)
        # Final result: plain Merge across partitions, then Terminate.
        final = gla.terminate(_merge_over_partitions(gla, finals, w_final, all_alive))
        if not snapshots:
            return QueryResult(final, None, None, d_total, d_local)

        # EstimatorTerminate per (partition, round) with the partition's |D_i|,
        # then EstimatorMerge across partitions (paper §3.1: intra- then inter-).
        terminated = gla.estimator_terminate(round_states, {"d_local": d_local})
        merged = _merge_rounds(gla, terminated, w_pr, gla.estimator_merge, all_alive)
        estimates = None
        if gla.estimate is not None:
            with obs.span("pfola.estimate"):
                estimates = gla.estimate(merged, confidence, {"d_total": d_total})
    return QueryResult(final, merged, estimates, d_total, d_local)


def _run_vmapped(gla: GLA, shards: dict, sched: np.ndarray, alive, *,
                 mode: str, emit: str, lanes: int, snapshots: bool,
                 confidence: float, all_alive: bool) -> QueryResult:
    """The whole-scan program over every partition at once."""
    with obs.span("pfola.scan"):
        finals, round_states, d_local = _scan_states(
            gla, shards, sched, mode=mode, emit=emit, lanes=lanes, snapshots=snapshots)
    return _merge_result(gla, finals, round_states, d_local, alive,
                         rounds=sched.shape[1] - 1, snapshots=snapshots,
                         confidence=confidence, all_alive=all_alive)


def _execute_full(gla: GLA, shards: dict, sched: np.ndarray, alive, *, mode: str,
                  emit: str, lanes: int, snapshots: bool, confidence: float,
                  all_alive: bool, mesh=None, sync_cost_model: bool = True
                  ) -> QueryResult:
    """Dispatch one whole-scan program: over every partition here, or over
    this rank's share of them (``shards``) under ``repro_torch.sharded``."""
    if mesh is None:
        return _run_vmapped(gla, shards, sched, alive, mode=mode, emit=emit,
                            lanes=lanes, snapshots=snapshots,
                            confidence=confidence, all_alive=all_alive)
    from repro_torch import sharded  # local: sharded imports engine
    return sharded.run_sharded(
        gla, shards, sched, alive, mesh=mesh, mode=mode, emit=emit, lanes=lanes,
        snapshots=snapshots, confidence=confidence, all_alive=all_alive,
        sync_cost_model=sync_cost_model)


# ---------------------------------------------------------------------------
# plan resolution and the public entry point
# ---------------------------------------------------------------------------

def normalize_plan(qspec: QS.QuerySpec, spec) -> QS.QuerySpec:
    """Validate the emit/kernel contracts and resolve the plan against the
    data's ``[P, C, L]`` shape: ``emit`` a concrete string, ``schedule`` a
    [P, R+1] ndarray, ``rounds`` its R.  ``spec`` is the data's
    ``ChunkSpec`` (the whole layout's, under a partition group).

    A multi-query spec is a TypeError: :func:`run_queries` bundles it first.
    Round-emission paths ("round", and group-by or bundle "kernel") emit at
    uniform round boundaries only: ``rounds`` degrades to the largest
    divisor of C with a warning, and an explicit schedule that is
    indivisible or non-uniform is a ValueError.
    """
    if qspec.is_multi:
        raise TypeError(
            "a QuerySpec holding a sequence of GLAs is a run_queries() "
            "plan — run_queries bundles it before execution")
    gla, emit = qspec.gla, qspec.resolved_emit()
    rounds, schedule = qspec.rounds, qspec.schedule
    P, C = spec.P, spec.C
    if emit not in ("chunk", "round", "round_masked", "kernel"):
        raise ValueError(f"unknown emit: {emit!r} (the port runs 'chunk', "
                         "'round', 'round_masked' and 'kernel')")
    if emit == "kernel":
        if gla.members:
            # one launch serves every member: either all publish a fused
            # contract (K1) or all publish kernel_cols (K3)
            if any(m.fused is None for m in gla.members):
                missing = [m.name for m in gla.members if m.kernel_cols is None]
                if missing:
                    raise ValueError(
                        f"bundle members {missing} do not publish kernel_cols "
                        "or a fused contract — emit='kernel' batches every "
                        "member into one dispatch and cannot mix in "
                        "scan-only members")
        elif gla.kernel_cols is None and gla.fused is None:
            raise ValueError(
                f"GLA {gla.name!r} publishes neither kernel_cols nor a "
                "fused kernel contract")
    needs_uniform = emit == "round" or (
        emit == "kernel" and (gla.kernel_num_groups is not None
                              or bool(gla.members)))
    if needs_uniform:
        if schedule is None:
            if C % rounds:
                best = max(d for d in range(1, rounds + 1) if C % d == 0)
                warnings.warn(
                    f"emit={emit!r} needs C % rounds == 0 (C={C}); degrading "
                    f"rounds {rounds} -> {best}", stacklevel=3)
                rounds = best
        else:
            sched = np.asarray(schedule)
            R = sched.shape[1] - 1
            if C % R:
                raise ValueError(f"emit={emit!r} needs C % rounds == 0, got "
                                 f"C={C} with a {R}-round schedule")
            if not np.array_equal(sched, uniform_schedule(P, C, R)):
                raise ValueError(
                    f"emit={emit!r} emits snapshots at uniform round "
                    "boundaries and cannot honor a non-uniform schedule — "
                    "use emit='round_masked' (large states, any schedule) "
                    "or emit='chunk' (prefix states)")
    if schedule is None:
        schedule = uniform_schedule(P, C, rounds)
    schedule = np.asarray(schedule)
    return qspec.with_(rounds=schedule.shape[1] - 1, schedule=schedule, emit=emit)


def run_query(spec, data, *, device=None, mesh=None, **plan) -> QueryResult:
    """Execute a GLA query with on-line estimation.

    A thin wrapper over :class:`repro_torch.session.Session` driven to
    completion: without a stopping rule the whole-scan program runs; with
    ``spec.stop`` the session advances round by round and ends as soon as
    the rule fires.

    Args:
      spec: a :class:`repro_torch.spec.QuerySpec` (or a bare GLA).
      data: columnar dict, leaves [P, C, L] incl. "_mask", or any
        :class:`repro_torch.data.source.ChunkSource`; a streaming source
        (``NpyMmapSource``, ``EncodedSource``) is scanned out of core, one
        prefetched round-slice at a time, with finals bitwise those of
        the resident run.
      device: where the query runs ("cuda" by default; "cpu" runs the
        kernels' plain versions; the group's device under ``mesh``).
      mesh: a :class:`repro_torch.sharded.PartitionGroup`: this process is
        one rank of several that run the query together, each over its
        own partitions (``data`` is this rank's resident block
        ``[P/W, C, L]``, or a source over the whole layout), and every
        rank returns the whole query's result, bitwise the one-process
        run's (``repro_torch.sharded``).
    """
    with obs.root("pfola.pass"):
        return _run_query(QS.coerce_spec(spec, plan, caller="run_query"), data,
                          device=device, mesh=mesh)


def _run_query(qspec: QS.QuerySpec, data, *, device, mesh) -> QueryResult:
    """:func:`run_query`'s pass, inside the caller's ``pfola.pass``."""
    from repro_torch import session as SN  # local: session imports engine

    return SN.Session(qspec, data, device=device, mesh=mesh).run()


def run_queries(specs, data, *, device=None, mesh=None, **plan):
    """Execute N concurrent OLA queries over ONE pass of the shards.

    The queries are stacked into a :func:`repro_torch.gla.GLABundle` (one
    tuple-of-states GLA), every scan path feeds all of them from the same
    chunks, and the result is unbundled into one :class:`QueryResult` per
    query.  Within the port each member's finals, snapshot states and
    bounds equal its solo :func:`run_query` on the scan paths and on the
    fused kernel path.

    ``specs`` is a :class:`repro_torch.spec.QuerySpec` whose ``gla`` is a
    sequence of GLAs (or a bare sequence).  The plan applies to the shared
    scan; ``emit`` resolves to ``"round"`` by default.  ``emit="kernel"``
    runs every member in one K1 launch per round-slice when all have a
    usable fused contract, else one K3 launch per round-slice over their
    ``kernel_cols``.  With ``spec.stop`` every member that estimates must
    converge before the bundle stops.  ``mesh`` runs it across processes,
    as :func:`run_query`.

    Returns: list of :class:`QueryResult`, one per GLA, in order.
    """
    from repro_torch.gla import GLABundle  # local: gla is a leaf module

    with obs.root("pfola.pass"):
        qspec = QS.coerce_spec(specs, plan, caller="run_queries")
        if not qspec.is_multi:
            raise TypeError("run_queries() takes a sequence of GLAs — for a "
                            "single query use run_query()")
        glas = list(qspec.gla)
        qspec = qspec.with_(emit=qspec.resolved_emit(), gla=GLABundle(glas))
        res = _run_query(qspec, data, device=device, mesh=mesh)
        return [QueryResult(res.final[i],
                            None if res.snapshots is None else res.snapshots[i],
                            None if res.estimates is None else res.estimates[i],
                            res.d_total, res.d_local)
                for i in range(len(glas))]


def audit_plan(gla, data, *, rounds: int = 8, schedule=None, emit: str = "chunk",
               mode: str = "async", lanes: int = 1, snapshots: bool = True,
               confidence: float = 0.95, mesh=None, device=None, checks=None,
               raise_on_failure: bool = False):
    """Certify a query plan against the invariant catalog before it runs.

    Thin re-export of :func:`repro_torch.audit.audit_plan`, as the
    reference's ``engine.audit_plan``; args mirror it, plus ``device``
    ("cuda" by default).  Returns an ``AuditReport``; the dry-step checks
    read one round-slice and throw the result away.
    """
    from repro_torch import audit as AU  # local: audit imports this module

    return AU.audit_plan(
        gla, data, rounds=rounds, schedule=schedule, emit=emit, mode=mode,
        lanes=lanes, snapshots=snapshots, confidence=confidence, mesh=mesh,
        device=device, checks=checks, raise_on_failure=raise_on_failure)
