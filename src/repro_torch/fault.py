"""Node-failure model — paper §4.6 made executable; port of
``repro/dist/fault.py``.

The engine expresses failure as an ``alive`` mask: [P] for partitions dead
throughout the query, [R, P] for an injection schedule (partition p
disappears at round ``fail_at[p]`` and its state — everything it had
accumulated — is lost, so it is excluded from every merge from that round
on).  This module owns the masks and the *estimator-level consequences*,
which differ per estimation model:

  * ``single``       — survives.  Under global randomization the union of
    the surviving partitions' scans is still a uniform without-replacement
    sample of the whole dataset; the estimator stays unbiased.  The price
    is a *variance floor*: |S| never reaches |D|, so the (|D|-|S|) factor
    of Eq. (4) never vanishes and the bounds never collapse
    (:func:`variance_floor`).
  * ``multiple``     — fails catastrophically.  A dead stratum's local
    estimator is gone and nothing bounds the missing term: the honest
    interval is (-inf, +inf) from the failure round on.
  * ``synchronized`` — stalls.  The Wu et al. barrier waits for every
    partition; a dead one never arrives, so estimates freeze at the last
    pre-failure round (infinite bounds if the failure precedes it).

The final result is always the aggregate over the surviving partitions'
data.  :func:`run_with_failures` injects a whole-scan schedule and
post-processes the stacked estimates; the live counterpart is
``repro_torch.session.FaultPolicy``, which uses the same schedules and the
per-round helpers here.  :class:`FailingSource` is the chaos wrapper that
makes a source actually die mid-scan.
"""
from __future__ import annotations

import threading
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import engine
from repro_torch import estimators as E
from repro_torch.data import source as DS
from repro_torch.spec import QuerySpec
from repro_torch.uda import GLA, Estimate, tree_map

# raised by sources (from the prefetcher's worker thread); its home is the
# data layer, re-exported here as part of the failure model
PartitionLostError = DS.PartitionLostError


def alive_mask(num_partitions: int, dead_partitions: Sequence[int]) -> np.ndarray:
    """[P] bool — False for partitions dead for the whole query."""
    alive = np.ones(num_partitions, bool)
    for p in dead_partitions:
        alive[p] = False
    return alive


def failure_schedule(num_partitions: int, rounds: int,
                     fail_at: Mapping[int, int]) -> np.ndarray:
    """[R, P] bool — partition p is alive during round r iff r < fail_at[p].

    ``fail_at[p] == 0`` means dead from the start; partitions absent from
    ``fail_at`` never fail.  Row r feeds the merge of snapshot r."""
    sched = np.ones((rounds, num_partitions), bool)
    for p, r in fail_at.items():
        sched[r:, p] = False
    return sched


def first_failure_round(alive) -> Optional[int]:
    """Earliest round with a dead partition, or None if all live throughout."""
    alive = np.asarray(alive)
    if alive.ndim == 1:
        return 0 if not alive.all() else None
    dead_rows = np.flatnonzero(~alive.all(axis=1))
    return int(dead_rows[0]) if dead_rows.size else None


def _from_round(x: torch.Tensor, fail_round: int) -> torch.Tensor:
    """[R, 1, ...] bool: round index >= ``fail_round``."""
    r = torch.arange(x.shape[0], device=x.device)
    return (r >= fail_round).reshape(-1, *([1] * (x.ndim - 1)))


def _poison(est: Estimate, fail_round: int) -> Estimate:
    """Bounds -> (-inf, +inf) from ``fail_round`` on (multiple model);
    ``est`` holds round-stacked leaves [R, ...]."""
    def after(x, v):
        return torch.where(_from_round(x, fail_round), torch.full_like(x, v), x)

    return Estimate(
        estimate=est.estimate,
        lower=tree_map(lambda x: after(x, -np.inf), est.lower),
        upper=tree_map(lambda x: after(x, np.inf), est.upper),
        info=est.info)


def _stall(est: Estimate, fail_round: int) -> Estimate:
    """Freeze round-stacked estimates at the last pre-failure round
    (synchronized model); infinite bounds when the failure is at round 0."""
    if fail_round == 0:
        return poison_bounds(est)

    def freeze(x):
        return torch.where(_from_round(x, fail_round), x[fail_round - 1], x)

    return Estimate(estimate=tree_map(freeze, est.estimate),
                    lower=tree_map(freeze, est.lower),
                    upper=tree_map(freeze, est.upper), info=est.info)


def poison_bounds(est: Estimate) -> Estimate:
    """An Estimate with bounds forced to (-inf, +inf), the point estimate
    kept: the ``multiple`` poison, and the ``synchronized`` stall before
    the first round, for one round's estimate (or a stack of them)."""
    return Estimate(
        estimate=est.estimate,
        lower=tree_map(lambda x: torch.full_like(x, -np.inf), est.lower),
        upper=tree_map(lambda x: torch.full_like(x, np.inf), est.upper),
        info=est.info)


def run_with_failures(
    gla: GLA,
    shards,
    dead_partitions: Sequence[int] = (),
    *,
    estimator: str = "single",
    rounds: int = 8,
    fail_at: Optional[Mapping[int, int]] = None,
    schedule: Optional[np.ndarray] = None,
    mode: str = "async",
    emit: str = "chunk",
    confidence: float = 0.95,
    device=None,
    mesh=None,
) -> engine.QueryResult:
    """Run a query under injected node failures and apply §4.6 semantics.

    ``dead_partitions`` fail before the query starts; ``fail_at`` maps
    partition -> failure round for mid-query failures.  ``estimator``
    names the estimation model the GLA was built with: the bounds'
    post-processing (poison / stall / pass-through) depends on it.
    ``shards`` is a shards dict or any chunk source.  ``mesh`` runs it as
    one rank of a partition group (``repro_torch.sharded``; ``shards`` is
    this rank's block or the whole layout's source): the failure schedule
    is the whole layout's, and every rank returns the whole result.
    """
    if mesh is None:
        spec = DS.as_source(shards).spec
    else:
        from repro_torch import sharded  # local: sharded imports engine

        spec = sharded.rank_view(mesh, shards).spec
    P, C = spec.P, spec.C
    if schedule is None:
        schedule = engine.uniform_schedule(P, C, rounds)
    R = schedule.shape[1] - 1
    if fail_at:
        at = {p: 0 for p in dead_partitions}
        at.update(fail_at)
        alive = failure_schedule(P, R, at)
    else:
        alive = alive_mask(P, dead_partitions)
    res = engine.run_query(
        QuerySpec(gla, schedule=schedule, sync=mode == "sync", emit=emit,
                  confidence=confidence, alive=alive), shards, device=device,
        mesh=mesh)
    fr = first_failure_round(alive)
    if fr is None or res.estimates is None:
        return res
    if estimator == "multiple":
        return res._replace(estimates=_poison(res.estimates, fr))
    if estimator == "synchronized":
        return res._replace(estimates=_stall(res.estimates, fr))
    return res  # single: unbiased as it is, variance floor > 0


def variance_floor(gla: GLA, shards, dead_partitions: Sequence[int], *,
                   device="cuda") -> float:
    """Residual estimator variance at a full scan of the surviving
    partitions (single model): failure caps |S| at the survivors'
    cardinality, so Eq. (4) bottoms out above 0 (0.0 when nothing died).
    Meaningful for SumState GLAs (sum and group-by, single or
    synchronized)."""
    P = DS.as_source(shards).spec.P
    res = engine.run_query(
        QuerySpec(gla, rounds=1, alive=alive_mask(P, dead_partitions)),
        shards, device=device)
    full = tree_map(lambda x: x[-1], res.snapshots)
    var = E.variance_estimate(full.sum, full.sumsq, full.scanned, res.d_total)
    return float(var.max())


class FailingSource(DS.ChunkSource):
    """Chaos wrapper: partition p's storage dies at chunk ``fail_chunk[p]``.

    The first read whose range [lo, hi) reaches a partition's fail chunk
    (``fail_chunk[p] < hi``) raises :class:`PartitionLostError` naming
    every newly dead partition — through the session's prefetcher, as a
    real read error would (the exception crosses the worker thread in the
    future).  The partitions are marked dead *before* the raise: the next
    prefetch may already run, and it must see them dead.  Later reads
    serve the dead partitions' columns and masks zeroed (:meth:`read_into`
    zeroes their rows of the caller's staging).  Dataset-level stats —
    the mask-chunk sums (|D| is a property of the data) and the
    fingerprint — are the inner source's.  ``resident`` is False even over
    in-memory data, so a session always takes the streaming path that
    detects the failure.  A read of a partition range (one rank's share,
    ``PartitionRangeSource``) sees only the failures of its partitions.
    """

    resident = False

    def __init__(self, inner, fail_chunk: Mapping[int, int]):
        self.inner = DS.as_source(inner)
        self.spec = self.inner.spec
        self.encodings = self.inner.encodings
        for p in fail_chunk:
            if not 0 <= int(p) < self.spec.P:
                raise ValueError(
                    f"fail_chunk names partition {p}, but the source has "
                    f"P={self.spec.P}")
        self._fail = {int(p): int(c) for p, c in fail_chunk.items()}
        self._dead: set = set()
        self._lock = threading.Lock()  # reads run on the prefetcher's thread

    def _dead_before(self, hi: int, plo: int, phi: int) -> list:
        """The dead partitions of [plo, phi) a read of [lo, hi) must zero,
        as offsets from ``plo``; raises when the read reaches the fail
        chunk of one of those partitions for the first time."""
        with self._lock:
            newly = sorted(p for p, c in self._fail.items()
                           if c < hi and p not in self._dead and plo <= p < phi)
            if newly:
                self._dead.update(newly)
                raise PartitionLostError(newly)
            return sorted(p - plo for p in self._dead if plo <= p < phi)

    def slice_cols(self, lo: int, hi: int) -> dict:
        return self.slice_parts(0, self.spec.P, lo, hi)

    def slice_parts(self, plo: int, phi: int, lo: int, hi: int) -> dict:
        dead = self._dead_before(hi, plo, phi)
        cols = {k: v.clone() if isinstance(v, torch.Tensor) else np.array(v, copy=True)
                for k, v in self.inner.slice_parts(plo, phi, lo, hi).items()}
        for v in cols.values() if dead else ():
            v[dead] = 0
        return cols

    def read_into(self, lo: int, hi: int, out: dict) -> None:
        self.read_parts_into(0, self.spec.P, lo, hi, out)

    def read_parts_into(self, plo: int, phi: int, lo: int, hi: int, out: dict) -> None:
        dead = self._dead_before(hi, plo, phi)
        self.inner.read_parts_into(plo, phi, lo, hi, out)
        for v in out.values() if dead else ():
            v[dead] = 0

    def mask_chunk_sums(self) -> np.ndarray:
        return self.inner.mask_chunk_sums()

    def mask_sums_parts(self, plo: int, phi: int) -> np.ndarray:
        return self.inner.mask_sums_parts(plo, phi)

    def fingerprint(self) -> str:
        return self.inner.fingerprint()
