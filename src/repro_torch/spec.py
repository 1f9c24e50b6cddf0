"""QuerySpec — the one query-plan object every entry point accepts.

Port of ``repro/core/spec.py``: the composable plan trees
(:class:`PlanNode` and its nodes, :func:`lower_plan`), ``QuerySpec`` with
its runtime fault policy, and ``coerce_spec``.  A ``QuerySpec`` whose
``gla`` is a sequence of GLAs is a :func:`repro_torch.engine.run_queries`
plan; a ``PlanNode`` tree handed to it is lowered onto the GLA
constructors at construction.  ``QuerySpec`` is plan-only: *where* the
plan runs (``device``) stays a per-call argument of ``run_query`` /
``Session``.
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


def _is_gla_sequence(gla) -> bool:
    """True when ``gla`` is a plain sequence of queries (run_queries), as
    opposed to a single GLA or a NamedTuple query description (a
    ``SlotQuery``)."""
    return isinstance(gla, (tuple, list)) and not hasattr(type(gla), "_fields")


# ---------------------------------------------------------------------------
# Composable OLA plan trees.
#
# A PlanNode tree is the declarative face of a query: a Scan leaf, an
# optional chain of Filter/Join stages, and an estimator root (SumAgg /
# GroupAgg / sketch roots, optionally wrapped in Having for Deep OLA
# nesting).  ``QuerySpec`` lowers any PlanNode handed to it through
# :func:`lower_plan` onto the existing GLA constructors: a one-node tree
# over a flat plan lowers to the same constructor call with the same
# closures, so its finals, snapshots and bounds are bitwise the flat
# plan's, on the scan paths and through the kernels alike.
#
# Every PlanNode subclass declares its ``monoid`` (how partial states
# merge: "sum" | "max" | "none" for pure stages) and ``estimator`` (which
# estimator family the root pairs with) as class attributes — the
# reference's contract rule C010, which lints every file under src/.
# ---------------------------------------------------------------------------


class PlanNode:
    """Base class of the plan tree.  Subclasses are frozen dataclasses with
    ``child`` links; ``lower()`` produces the executable GLA.  Identity
    semantics (``eq=False``): nodes may hold tensors (probe tables) and
    are never used as cache keys themselves."""

    monoid = "none"
    estimator = "none"

    def lower(self):
        return lower_plan(self)


@dataclasses.dataclass(frozen=True, eq=False)
class Scan(PlanNode):
    """Leaf: the randomized fact-table scan.  ``d_total`` = |D|."""

    monoid = "none"
    estimator = "none"

    d_total: float


@dataclasses.dataclass(frozen=True, eq=False)
class Filter(PlanNode):
    """Selection stage: ``cond(chunk) -> [..., L] in {0,1}``.  Multiple
    Filter stages combine multiplicatively (conjunction)."""

    monoid = "none"
    estimator = "none"

    child: Any
    cond: Any


@dataclasses.dataclass(frozen=True, eq=False)
class Join(PlanNode):
    """Fact-to-dimension hash probe (paper Alg. 4 / §3.3).

    ``dim_group[k]`` / ``dim_valid[k]`` are the replicated dimension arrays
    indexed by ``join_key(chunk)``; the GroupAgg root above this stage
    groups by the probed attribute.  ``d_dim``/``s_dim`` opt into the §3.3
    multiplicative join estimator scale for sampled dimension tables
    (resident tables — the default — scale by exactly 1).

    ``device`` is where lowering puts the probe tables ("cuda" by default,
    as every entry point): :func:`repro_torch.gla.make_join_groupby_gla`
    places them there, beside the chunks its closures index them with.
    The reference's node has no such field (JAX places arrays itself).
    """

    monoid = "none"
    estimator = "multiplicative"

    child: Any
    join_key: Any
    dim_group: Any
    dim_valid: Any
    d_dim: Optional[float] = None
    s_dim: Optional[float] = None
    device: Any = "cuda"


@dataclasses.dataclass(frozen=True, eq=False)
class SumAgg(PlanNode):
    """Estimator root: SUM(func(d)) with the Eq. (2)/(4) sampling estimator
    (``model``: single | multiple | synchronized | none)."""

    monoid = "sum"
    estimator = "horvitz"

    child: Any
    func: Any
    num_aggs: int = 1
    model: str = "single"


@dataclasses.dataclass(frozen=True, eq=False)
class GroupAgg(PlanNode):
    """Estimator root: GROUP BY SUM with per-group sampling estimators.

    ``group`` maps fact chunks to dense ids; leave it None above a Join
    stage (the probed ``dim_group`` provides the grouping).
    """

    monoid = "sum"
    estimator = "horvitz-per-group"

    child: Any
    func: Any
    num_groups: int
    group: Any = None
    num_aggs: int = 1
    model: str = "single"
    bucket_bits: Optional[int] = None


@dataclasses.dataclass(frozen=True, eq=False)
class Having(PlanNode):
    """Deep OLA nesting root: SUM over groups whose *estimated* inner
    aggregate passes ``estimate <mode> threshold``, variance propagated
    (estimators.nested_group_estimate).  ``child`` must lower to a
    group-shaped estimating GLA (a GroupAgg-rooted plan)."""

    monoid = "sum"
    estimator = "nested-normal"

    child: Any
    threshold: Any
    mode: str = ">="
    agg: int = 0


@dataclasses.dataclass(frozen=True, eq=False)
class CountDistinct(PlanNode):
    """Sketch root: COUNT(DISTINCT key(d)) via HLL-style registers.  Max
    monoid — not additive, so never over ``mesh=`` (repro_torch.sketch)."""

    monoid = "max"
    estimator = "hll-normal"

    child: Any
    key: Any
    log2m: int = 12


@dataclasses.dataclass(frozen=True, eq=False)
class Quantile(PlanNode):
    """Sketch root: the q-quantile of value(d) over [lo, hi) via an
    additive fixed-bin histogram CDF with DKW bands."""

    monoid = "sum"
    estimator = "dkw"

    child: Any
    value: Any
    lo: float
    hi: float
    bins: int = 256
    q: float = 0.5


@dataclasses.dataclass(frozen=True, eq=False)
class HeavyHitters(PlanNode):
    """Sketch root: per-candidate frequencies via an additive count-min
    sketch, Horvitz–Thompson-scaled with the CM overcount bound."""

    monoid = "sum"
    estimator = "cms-ht"

    child: Any
    key: Any
    candidates: Any
    width: int = 1024
    depth: int = 4


def _unstack_stages(node):
    """Walk an estimator root's child chain down to the Scan leaf.

    Returns ``(scan, conds, join)`` — the leaf, the Filter conds in
    scan-to-root order, and the single Join stage (or None).
    """
    conds, join = [], None
    cur = node
    while not isinstance(cur, Scan):
        if isinstance(cur, Filter):
            conds.append(cur.cond)
        elif isinstance(cur, Join):
            if join is not None:
                raise ValueError("plan trees support one Join stage")
            join = cur
        elif isinstance(cur, PlanNode):
            raise ValueError(
                f"{type(cur).__name__} is an estimator root — it cannot "
                f"appear below another root")
        else:
            raise TypeError(f"not a PlanNode: {cur!r}")
        cur = cur.child
    return cur, conds[::-1], join


def _combined_cond(conds, *, optional=False):
    """Conjunction of Filter conds.  A single cond is returned as-is, so a
    one-Filter tree hands the constructor the very closure the flat
    spelling would — identical GLA arguments, bitwise-identical plans."""
    if len(conds) == 1:
        return conds[0]
    if not conds:
        if optional:
            return None

        def cond_true(chunk):
            import torch

            return torch.ones_like(chunk["_mask"])

        return cond_true

    def cond_all(chunk):
        w = conds[0](chunk)
        for c in conds[1:]:
            w = w * c(chunk)
        return w

    return cond_all


def lower_plan(node):
    """Lower a PlanNode tree onto the executable GLA constructors
    (``repro_torch.gla`` / ``repro_torch.sketch``).

    Stages collapse into the constructor arguments of their estimator
    root — Filters into ``cond``, a Join into the probe arrays of
    ``make_join_groupby_gla`` (placed on the Join's ``device``) — and
    Having wraps the lowered child through ``gla.make_having_gla``.
    Imports are function-local: ``gla`` and ``sketch`` sit above this
    module.
    """
    from repro_torch import gla as G

    if not isinstance(node, PlanNode):
        raise TypeError(f"lower_plan() takes a PlanNode, got {node!r}")
    if isinstance(node, Having):
        inner = lower_plan(node.child)
        return G.make_having_gla(
            inner, node.threshold, mode=node.mode, agg=node.agg)
    if isinstance(node, SumAgg):
        scan, conds, join = _unstack_stages(node.child)
        if join is not None:
            raise ValueError(
                "Join plans need a GroupAgg root — the grouping comes "
                "from the probed dimension attribute")
        return G.make_sum_gla(
            node.func, _combined_cond(conds), d_total=scan.d_total,
            estimator=node.model, num_aggs=node.num_aggs)
    if isinstance(node, GroupAgg):
        scan, conds, join = _unstack_stages(node.child)
        cond = _combined_cond(conds)
        if join is None:
            if node.group is None:
                raise ValueError("GroupAgg over a plain scan needs group=")
            return G.make_groupby_gla(
                node.func, cond, node.group, num_groups=node.num_groups,
                d_total=scan.d_total, estimator=node.model,
                num_aggs=node.num_aggs, bucket_bits=node.bucket_bits)
        if node.group is not None:
            raise ValueError(
                "GroupAgg above a Join groups by the probed dim_group — "
                "drop group=")
        return G.make_join_groupby_gla(
            node.func, cond, join.join_key, join.dim_group, join.dim_valid,
            num_groups=node.num_groups, d_total=scan.d_total,
            estimator=node.model, num_aggs=node.num_aggs,
            bucket_bits=node.bucket_bits, d_dim=join.d_dim,
            s_dim=join.s_dim, device=join.device)

    from repro_torch import sketch as SK

    if isinstance(node, (CountDistinct, Quantile, HeavyHitters)):
        scan, conds, join = _unstack_stages(node.child)
        if join is not None:
            raise ValueError("sketch roots run over plain filtered scans")
        cond = _combined_cond(conds, optional=True)
        if isinstance(node, CountDistinct):
            return SK.make_count_distinct_gla(
                node.key, d_total=scan.d_total, log2m=node.log2m, cond=cond)
        if isinstance(node, Quantile):
            return SK.make_quantile_gla(
                node.value, lo=node.lo, hi=node.hi, d_total=scan.d_total,
                bins=node.bins, q=node.q, cond=cond)
        return SK.make_heavy_hitters_gla(
            node.key, node.candidates, d_total=scan.d_total,
            width=node.width, depth=node.depth, cond=cond)
    raise ValueError(
        f"{type(node).__name__} is not an estimator root — plans lower "
        f"from their root node")


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
      plan        the PlanNode tree ``gla`` was lowered from, when the spec
                  was built from one (read-only provenance; a GLA-built
                  spec leaves it None).

    ``gla`` also accepts a :class:`PlanNode` tree, or a sequence mixing
    trees and GLAs: it is lowered through :func:`lower_plan` at
    construction, the original kept in ``plan``.
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
    plan: Optional[Any] = None

    def __post_init__(self):
        if self.fault is not None and self.estimator_merge is not None:
            raise ValueError(
                "QuerySpec: pass either fault= (a FaultPolicy) or "
                "estimator_merge= (its shorthand), not both")
        g = self.gla
        if isinstance(g, PlanNode):
            object.__setattr__(self, "plan", g)
            object.__setattr__(self, "gla", lower_plan(g))
        elif _is_gla_sequence(g) and any(isinstance(m, PlanNode) for m in g):
            object.__setattr__(self, "plan", g)
            object.__setattr__(self, "gla", type(g)(
                lower_plan(m) if isinstance(m, PlanNode) else m for m in g))

    @property
    def mode(self) -> str:
        return "sync" if self.sync else "async"

    @property
    def is_multi(self) -> bool:
        return _is_gla_sequence(self.gla)

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
