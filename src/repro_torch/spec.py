"""QuerySpec — the one query-plan object every entry point accepts.

Port of ``repro/core/spec.py:337-461`` (``QuerySpec`` with its runtime
fault policy, and ``coerce_spec``; plan trees come in a later slice).  A ``QuerySpec`` whose ``gla`` is a
sequence of GLAs is a :func:`repro_torch.engine.run_queries` plan.
``QuerySpec`` is plan-only: *where* the plan runs (``device``) stays a
per-call argument of ``run_query`` / ``Session``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

#: Loose plan kwargs accepted, with a DeprecationWarning, by the
#: ``run_query``/``Session`` shims.  ``mode`` maps onto ``QuerySpec.sync``.
DEPRECATED_PLAN_KWARGS = (
    "rounds", "schedule", "stop", "confidence", "mode", "emit", "lanes",
    "snapshots", "alive", "fault", "estimator_merge", "sync_cost_model",
)


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One OLA query plan.

      gla         the GLA to run, or a sequence of GLAs for run_queries().
      rounds      snapshot points over the scan.
      schedule    cumulative chunk boundaries [P, R+1]; None = uniform.
      stop        stopping rule (``repro_torch.session.rel_width`` et al.).
      emit        state-emission discipline: "chunk" (prefix states, any
                  schedule), "round" (round-boundary states),
                  "round_masked" (round-boundary states, any schedule) or
                  "kernel" (the CUDA kernels); None resolves to "chunk",
                  or to "round" for a multi-query plan.
      sync        True = the Wu et al. synchronized estimator barrier.
      lanes       parallel GLA states per partition.
      snapshots   False = non-interactive mode (no per-round states).
      confidence  CI level for estimates.
      alive       static liveness mask [P] or [R, P] (paper §4.6).
      fault       runtime ``repro_torch.session.FaultPolicy``; exclusive
                  with ``estimator_merge``.
      estimator_merge  shorthand for the fault-estimator family ("single" |
                  "multiple" | "synchronized"): resolves to
                  ``FaultPolicy(estimator_merge)`` when ``fault`` is not
                  given.
      sync_cost_model  sharded sync mode only: pay the per-chunk
                  coordination collective (``repro_torch.sharded``); the
                  single-process paths ignore it.
    """

    gla: Any
    rounds: int = 8
    schedule: Optional[Any] = None
    stop: Optional[Any] = None
    emit: Optional[str] = None
    sync: bool = False
    lanes: int = 1
    snapshots: bool = True
    confidence: float = 0.95
    alive: Optional[Any] = None
    fault: Optional[Any] = None
    estimator_merge: Optional[str] = None
    sync_cost_model: bool = True

    def __post_init__(self):
        if self.fault is not None and self.estimator_merge is not None:
            raise ValueError(
                "QuerySpec: pass either fault= (a FaultPolicy) or "
                "estimator_merge= (its shorthand), not both")

    @property
    def mode(self) -> str:
        return "sync" if self.sync else "async"

    @property
    def is_multi(self) -> bool:
        return isinstance(self.gla, (tuple, list))

    def resolved_emit(self) -> str:
        if self.emit is not None:
            return self.emit
        return "round" if self.is_multi else "chunk"

    def resolved_fault(self):
        """The runtime fault policy: ``fault`` as given, or one built from
        the ``estimator_merge`` shorthand."""
        if self.fault is not None or self.estimator_merge is None:
            return self.fault
        from repro_torch.session import FaultPolicy  # session imports spec

        return FaultPolicy(self.estimator_merge)

    def with_(self, **kw) -> "QuerySpec":
        return dataclasses.replace(self, **kw)


def coerce_spec(spec_or_gla, legacy: dict, *, caller: str) -> QuerySpec:
    """The shim behind every entry point: a ready :class:`QuerySpec` passes
    through (loose kwargs beside it are a TypeError); a bare GLA is wrapped,
    with one ``DeprecationWarning`` when loose plan kwargs come with it."""
    if isinstance(spec_or_gla, QuerySpec):
        if legacy:
            raise TypeError(
                f"{caller}(): pass the plan inside the QuerySpec, not as "
                f"loose kwargs too ({sorted(legacy)})")
        return spec_or_gla
    if not legacy:
        return QuerySpec(gla=spec_or_gla)
    unknown = sorted(set(legacy) - set(DEPRECATED_PLAN_KWARGS))
    if unknown:
        raise TypeError(f"{caller}() got unexpected keyword arguments: {unknown}")
    warnings.warn(
        f"{caller}(gla, data, {'/'.join(sorted(legacy))}=...) loose plan "
        f"kwargs are deprecated — pass {caller}(QuerySpec(gla, ...), data)",
        DeprecationWarning, stacklevel=3)
    kw = dict(legacy)
    mode = kw.pop("mode", None)
    if mode is not None:
        if mode not in ("async", "sync"):
            raise ValueError(f"mode must be 'async' or 'sync', got {mode!r}")
        kw["sync"] = mode == "sync"
    return QuerySpec(gla=spec_or_gla, **kw)
