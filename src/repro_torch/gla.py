"""Concrete GLAs — paper Algorithms 1, 3 and 4, and multi-query bundles.

Port of ``repro/core/gla.py:37-133,149-826``:

  * :func:`make_sum_gla`          — §4.3 single-table SUM/COUNT (Alg. 1;
                                    Alg. 2 with ``estimator="multiple"``)
  * :func:`make_groupby_gla`      — §4.4 group-by aggregation (Alg. 3), with
                                    the hash-bucketed large-domain table
  * :func:`make_join_groupby_gla` — §4.5 join group-by with a replicated
                                    dimension table (Alg. 4)
  * :func:`GLABundle`             — §3 any number of queries over one scan
  * :func:`compose`, :func:`make_having_gla` — Deep OLA nesting: an outer
                                    estimator over the inner estimate
  * :class:`SlotFamily`           — padded-slot query families, the
                                    serving layer's dynamic bundle

Queries are ``func(chunk) -> [..., L] or [..., L, A]`` values (A
simultaneous aggregates, like TPC-H Q1's four SUMs) and ``cond(chunk) ->
[..., L]`` 0/1 predicates; group-by adds ``group(chunk) -> [..., L]`` int
ids.  Chunk columns are ``[B, L]`` with the partition (or lane) axis written
out as ``B``, and states carry the same leading axis (uda module doc).

States are float32 ``SumState``s, so every GLA here publishes the fused
kernel contract (``FusedSpec``) that ``emit="kernel"`` runs, and the
legacy ``kernel_cols`` projection (scalar with A == 1, and group-by) that
it falls back to when the fused contract cannot be used — except the
``"multiple"`` estimator's, whose ``MultState`` no kernel publishes (as in
the reference): it runs on ``emit="chunk"`` and ``"round"``.
"""
from __future__ import annotations

import weakref
from functools import partial
from typing import Callable, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import estimators as E
from repro_torch._device import resolve_device
from repro_torch.uda import GLA, Chunk, Estimate, FusedSpec, ProbeTable, tree_map

_F32 = torch.float32


def _as_2d(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[..., L] -> [..., L, 1]; [..., L, A] stays."""
    return vals.unsqueeze(-1) if vals.ndim == mask.ndim else vals


def _add(a, b):
    return tree_map(torch.add, a, b)


# ---------------------------------------------------------------------------
# Multi-query bundles (paper §3: any number of concurrent estimators over
# one execution).  A bundle is a GLA whose state is the tuple of member
# states, so every scan path runs N queries over one pass of the chunks;
# each member sees the same chunks in the same order as it would alone.
# ---------------------------------------------------------------------------

def GLABundle(glas: Sequence[GLA], *, name: Optional[str] = None) -> GLA:
    """Stack GLAs into one GLA over a shared scan.

    The state is ``tuple(member states)``; every GLA function applies
    member-wise.  ``estimate`` returns one :class:`Estimate` per member
    (``None`` for members without an estimation model).  The bundle
    publishes no kernel contract of its own: ``emit="kernel"`` runs all
    members in one K1 launch per round-slice when every member has a
    usable fused contract, else one K3 launch per round-slice over every
    member's ``kernel_cols`` projection.  Bundling the same members again
    returns the same bundle object while that object is alive: the memo
    holds no bundle, so that the members of a dropped bundle, and the
    dimension tables their closures hold, are freed with it.  Use
    :func:`repro_torch.engine.run_queries` to run one.
    """
    members = tuple(glas)
    if not members:
        raise ValueError("GLABundle needs at least one member GLA")
    if any(m.members for m in members):
        raise ValueError("GLABundle members must not themselves be bundles")
    key = (members, name)
    bundle = _BUNDLES.get(key)
    if bundle is None:
        bundle = _BUNDLES[key] = _combine_members(members, name)
    return bundle


#: live bundles by (members, name): an entry goes with its bundle
_BUNDLES: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _combine_members(members: tuple, name: Optional[str]) -> GLA:
    """The tuple-of-states combinator behind :func:`GLABundle`."""
    def init(device):
        return tuple(m.init(device) for m in members)

    def accumulate(state, chunk):
        return tuple(m.accumulate(s, chunk) for m, s in zip(members, state))

    def merge(a, b):
        return tuple(m.merge(x, y) for m, x, y in zip(members, a, b))

    def terminate(state):
        return tuple(m.terminate(s) for m, s in zip(members, state))

    def estimator_terminate(state, ctx=None):
        return tuple(m.estimator_terminate(s, ctx)
                     for m, s in zip(members, state))

    def estimator_merge(a, b):
        return tuple(m.estimator_merge(x, y) for m, x, y in zip(members, a, b))

    def estimate(state, confidence, ctx=None):
        return tuple(
            m.estimate(s, confidence, ctx) if m.estimate is not None else None
            for m, s in zip(members, state))

    any_estimate = any(m.estimate is not None for m in members)
    return GLA(
        init=init, accumulate=accumulate, merge=merge, terminate=terminate,
        estimator_terminate=estimator_terminate,
        estimator_merge=estimator_merge,
        estimate=estimate if any_estimate else None,
        merge_is_additive=all(m.merge_is_additive for m in members),
        members=members,
        name=name or "bundle[" + "+".join(m.name for m in members) + "]",
    )


# ---------------------------------------------------------------------------
# Hash-bucketed group tables (paper §4.4 large-domain group-by).  Raw ids are
# folded into 2**bucket_bits buckets by a multiplicative hash with an odd
# multiplier, a bijection on [0, 2**b): domains of at most 2**b raw ids map
# injectively, so de-bucketing is exact.
# ---------------------------------------------------------------------------

_BUCKET_MULT = 2654435761  # 2**32 / golden ratio (Knuth), odd


def mul32(u: torch.Tensor, mult: int) -> torch.Tensor:
    """``u * mult`` mod 2**32 for int64 ``u`` in [0, 2**32): the
    reference's wrapping uint32 product.  Formed from the multiplier's two
    16-bit halves, so no intermediate exceeds 2**48 and the low 32 bits
    are exact."""
    hi, lo = mult >> 16, mult & 0xFFFF
    return (u * lo + (((u * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF


def hash_bucket(gids: torch.Tensor, bucket_bits: int) -> torch.Tensor:
    """Raw group ids -> int32 bucket ids in [0, 2**bucket_bits).

    The reference multiplies in uint32, wrapping mod 2**32; :func:`mul32`
    gives the same low 32 bits, hence the same bucket ids."""
    h = mul32(gids.to(torch.int64) & 0xFFFFFFFF, _BUCKET_MULT)
    return (h & ((1 << bucket_bits) - 1)).to(torch.int32)


def debucket(bucket_vals: torch.Tensor, raw_ids, bucket_bits: int):
    """Gather per-raw-id rows from a bucketed group table [2**b, ...]."""
    idx = hash_bucket(torch.as_tensor(raw_ids, device=bucket_vals.device),
                      bucket_bits)
    return bucket_vals[idx.long()]


def _check_estimator(estimator: str) -> None:
    if estimator not in ("single", "multiple", "synchronized", "none"):
        raise ValueError(f"unknown estimator model: {estimator!r}")


def _mult_gla(base: GLA, state_shape: tuple, *, squeeze: bool,
              name: str) -> GLA:
    """Paper Alg. 2 around a SumState GLA's accumulate: the state is a
    :class:`estimators.MultState` whose ``base`` accumulates locally and
    whose ``(est, estvar)`` (shape ``state_shape``) EstimatorTerminate
    fills per partition with that partition's |D_i|.  Like the
    reference's, it publishes no fused and no ``kernel_cols`` contract:
    it runs on ``emit="chunk"``/``"round"``."""
    def zero(device):
        z = torch.zeros(state_shape, dtype=_F32, device=device)
        return E.MultState(base=base.init(device), est=z, estvar=z.clone())

    def acc(state: E.MultState, chunk: Chunk) -> E.MultState:
        return E.MultState(base.accumulate(state.base, chunk), state.est,
                           state.estvar)

    def est_term(state: E.MultState, ctx) -> E.MultState:
        return E.mult_estimator_terminate(state, d_local=ctx["d_local"])

    def estimate(state: E.MultState, confidence, ctx=None) -> Estimate:
        e = E.mult_estimate(state, confidence)
        if not squeeze:
            return e
        return Estimate(e.estimate[..., 0], e.lower[..., 0], e.upper[..., 0],
                        info={"var": e.info["var"][..., 0]})

    return GLA(
        init=zero, accumulate=acc, merge=_add,
        terminate=lambda s: base.terminate(s.base),
        estimator_terminate=est_term, estimator_merge=_add, estimate=estimate,
        merge_is_additive=True, name=name)


# ---------------------------------------------------------------------------
# Paper Alg. 1 — GLASum, single / synchronized / none
# ---------------------------------------------------------------------------

def make_sum_gla(
    func: Callable[[Chunk], torch.Tensor],
    cond: Callable[[Chunk], torch.Tensor],
    *,
    d_total: float,
    estimator: str = "single",
    num_aggs: int = 1,
) -> GLA:
    """SUM(func(d)) WHERE cond(d) — paper query (1).

    ``estimator``: "single" (Alg. 1), "multiple" (Alg. 2: stratified, one
    local estimator per partition, state :class:`estimators.MultState`),
    "synchronized" (Wu et al.; same state as single — the barrier lives in
    the engine), or "none" (plain aggregate, no estimation model).
    """
    _check_estimator(estimator)
    A = num_aggs

    def zero_sum(device):
        z = torch.zeros((A,), dtype=_F32, device=device)
        s = torch.zeros((), dtype=_F32, device=device)
        return E.SumState(sum=z, sumsq=z.clone(), scanned=s, matched=s.clone())

    def acc_sum(state: E.SumState, chunk: Chunk) -> E.SumState:
        mask = chunk["_mask"]
        vals = _as_2d(func(chunk), mask).to(_F32)  # [..., L, A]
        w = (cond(chunk) * mask).to(_F32)  # [..., L]
        m = mask.to(_F32)
        # multiply-then-reduce, as the reference's acc_sum
        return E.SumState(
            sum=state.sum + (vals * w[..., None]).sum(dim=-2),
            sumsq=state.sumsq + ((vals * vals) * w[..., None]).sum(dim=-2),
            scanned=state.scanned + m.sum(dim=-1),
            matched=state.matched + w.sum(dim=-1),
        )

    def terminate(state):
        return state.sum if A > 1 else state.sum[..., 0]

    def estimate(state: E.SumState, confidence, ctx=None) -> Estimate:
        est = E.horvitz_estimate(state.sum, state.scanned, d_total)
        var = E.variance_estimate(state.sum, state.sumsq, state.scanned, d_total)
        lo, hi = E.normal_bounds(est, var, confidence)

        def sq(x):
            return x if A > 1 else x[..., 0]

        return Estimate(sq(est), sq(lo), sq(hi),
                        info={"var": sq(var), "frac": state.scanned / d_total})

    def kernel_cols(chunk):  # the legacy scalar contract: A == 1 only
        return func(chunk), cond(chunk)

    if estimator == "multiple":
        single = GLA(init=zero_sum, accumulate=acc_sum, merge=_add,
                     terminate=terminate)
        return _mult_gla(single, (A,), squeeze=A == 1, name="sum-multiple")
    return GLA(
        init=zero_sum, accumulate=acc_sum, merge=_add, terminate=terminate,
        estimate=None if estimator == "none" else estimate,
        merge_is_additive=True, kernel_cols=kernel_cols if A == 1 else None,
        fused=FusedSpec(func=func, cond=cond, group=None, num_aggs=A),
        name=f"sum-{estimator}",
    )


# ---------------------------------------------------------------------------
# Paper Alg. 3 — GLAGroupBy (composite GLA: a GLASum per group)
# ---------------------------------------------------------------------------

def segment_sum(data: torch.Tensor, gids: torch.Tensor, num_groups: int):
    """Per-batch segment sums: ``data [..., L, K]`` by ``gids [..., L]``
    into ``[..., G, K]``.  Ids outside [0, G) are dropped, as
    ``jax.ops.segment_sum`` drops them: they add into one row past the
    table, which is cut off (no boolean indexing, so no wait for the
    device).  Deterministic on the CPU (``index_add_`` adds in row order
    there)."""
    lead = gids.shape[:-1]
    B = 1
    for n in lead:
        B *= n
    K = data.shape[-1]
    g = gids.reshape(B, -1).to(torch.int64)
    idx = g + torch.arange(B, device=g.device)[:, None] * num_groups
    dump = B * num_groups
    idx = torch.where((g >= 0) & (g < num_groups), idx, dump)
    out = torch.zeros((dump + 1, K), dtype=data.dtype, device=data.device)
    out.index_add_(0, idx.reshape(-1), data.reshape(-1, K))
    return out[:dump].reshape(*lead, num_groups, K)


def make_groupby_gla(
    func: Callable[[Chunk], torch.Tensor],
    cond: Callable[[Chunk], torch.Tensor],
    group: Callable[[Chunk], torch.Tensor],
    *,
    num_groups: int,
    d_total: float,
    estimator: str = "single",
    num_aggs: int = 1,
    bucket_bits: Optional[int] = None,
) -> GLA:
    """GROUP BY gAtts SUM(func(d)) WHERE cond(d) — paper query (5).

    State is the dense composite of per-group GLASum states: sums/sumsqs/
    matched are [G, A]/[G]; ``scanned`` is global.  ``bucket_bits`` folds
    raw ids through :func:`hash_bucket` into 2**bucket_bits buckets (the
    paper's large-domain Q1); recover per-raw-id rows with :func:`debucket`.
    """
    _check_estimator(estimator)
    A = num_aggs
    if bucket_bits is not None:
        raw_group = group

        def group(chunk):  # bucketed view of the raw ids
            return hash_bucket(raw_group(chunk), bucket_bits)

        G = 1 << bucket_bits
    else:
        G = num_groups

    def zero(device):
        return E.SumState(
            sum=torch.zeros((G, A), dtype=_F32, device=device),
            sumsq=torch.zeros((G, A), dtype=_F32, device=device),
            scanned=torch.zeros((), dtype=_F32, device=device),
            matched=torch.zeros((G,), dtype=_F32, device=device),
        )

    def acc(state: E.SumState, chunk: Chunk) -> E.SumState:
        mask = chunk["_mask"]
        vals = _as_2d(func(chunk), mask).to(_F32)  # [..., L, A]
        w = (cond(chunk) * mask).to(_F32)  # [..., L]
        gids = group(chunk)
        vw = vals * w[..., None]
        return E.SumState(
            sum=state.sum + segment_sum(vw, gids, G),
            sumsq=state.sumsq + segment_sum(vals * vw, gids, G),
            scanned=state.scanned + mask.to(_F32).sum(dim=-1),
            matched=state.matched + segment_sum(w[..., None], gids, G)[..., 0],
        )

    def estimate(state: E.SumState, confidence, ctx=None) -> Estimate:
        est = E.horvitz_estimate(state.sum, state.scanned, d_total)  # [..., G, A]
        var = E.variance_estimate(state.sum, state.sumsq, state.scanned, d_total)
        lo, hi = E.normal_bounds(est, var, confidence)
        return Estimate(est, lo, hi, info={"var": var, "matched": state.matched})

    def kernel_cols(chunk):  # ``group`` is the bucketed view already
        return func(chunk), cond(chunk), group(chunk)

    suffix = f"-b{bucket_bits}" if bucket_bits is not None else ""
    if estimator == "multiple":
        single = GLA(init=zero, accumulate=acc, merge=_add,
                     terminate=lambda s: s.sum)
        return _mult_gla(single, (G, A), squeeze=False,
                         name=f"groupby-multiple{suffix}")
    return GLA(
        init=zero, accumulate=acc, merge=_add, terminate=lambda s: s.sum,
        estimate=None if estimator == "none" else estimate,
        merge_is_additive=True, kernel_cols=kernel_cols, kernel_num_groups=G,
        fused=FusedSpec(func=func, cond=cond, group=group, num_aggs=A,
                        num_groups=G),
        name=f"groupby-{estimator}{suffix}",
    )


# ---------------------------------------------------------------------------
# Paper Alg. 4 — GLAJoin (replicated in-memory dimension table)
# ---------------------------------------------------------------------------

def make_join_groupby_gla(
    func: Callable[[Chunk], torch.Tensor],
    cond: Callable[[Chunk], torch.Tensor],
    join_key: Callable[[Chunk], torch.Tensor],
    dim_group,
    dim_valid,
    *,
    num_groups: int,
    d_total: float,
    estimator: str = "single",
    num_aggs: int = 1,
    bucket_bits: Optional[int] = None,
    d_dim: Optional[float] = None,
    s_dim: Optional[float] = None,
    device="cuda",
) -> GLA:
    """Join group-by — paper query (6), the dimension side replicated and
    probed by key.

    ``dim_group[k]`` is the group the dimension row with key ``k`` maps to
    (supplier -> nation, order -> segment), ``dim_valid[k]`` its predicate
    cond_M.  Both are put on ``device`` ("cuda" by default, as the other
    entry points): the closures index them with the chunk's keys, which
    live there.  Accumulate = probe (gather) + GLAGroupBy accumulate.

    The fused contract reads the same arrays as :class:`ProbeTable` s
    (``FusedSpec.probe_tables``) through ``chunk[pt.key]``.  Whether it is
    used is the reference's routing rule: ``fused_agg.fused_available`` is
    False when the probe tables exceed its budget, and the plan then runs
    the legacy ``kernel_cols`` path (K3).

    §3.3 multiplicative join estimator: ``d_dim`` (dimension cardinality)
    and ``s_dim`` (rows of it sampled so far, default ``d_dim``) scale the
    estimate by ``d_dim / s_dim``; without ``d_dim`` the estimate is the
    single-table Horvitz–Thompson formula.
    """
    dev = resolve_device(device)
    dim_group = torch.as_tensor(dim_group, dtype=torch.int32, device=dev)
    dim_valid = torch.as_tensor(dim_valid, device=dev)

    def joined_group(chunk: Chunk) -> torch.Tensor:
        return dim_group[join_key(chunk).long()]

    def joined_cond(chunk: Chunk) -> torch.Tensor:
        c = cond(chunk)
        return c * dim_valid[join_key(chunk).long()].to(c.dtype)

    inner = make_groupby_gla(
        func, joined_cond, joined_group, num_groups=num_groups,
        d_total=d_total, estimator=estimator, num_aggs=num_aggs,
        bucket_bits=bucket_bits)

    pt_group = ProbeTable("dim_group", dim_group)
    pt_valid = ProbeTable("dim_valid", dim_valid)

    def fused_group(chunk: Chunk) -> torch.Tensor:
        gids = chunk[pt_group.key][join_key(chunk).long()]
        return gids if bucket_bits is None else hash_bucket(gids, bucket_bits)

    def fused_cond(chunk: Chunk) -> torch.Tensor:
        c = cond(chunk)
        return c * chunk[pt_valid.key][join_key(chunk).long()].to(c.dtype)

    fused = None if inner.fused is None else inner.fused._replace(
        cond=fused_cond, group=fused_group, probe_tables=(pt_group, pt_valid))

    est_fn = inner.estimate
    if est_fn is not None and d_dim is not None:
        sd = float(d_dim if s_dim is None else s_dim)
        scale = (torch.tensor(float(d_dim), dtype=_F32)
                 / torch.tensor(max(sd, 1.0), dtype=_F32))
        inner_estimate = est_fn

        def est_fn(state, confidence, ctx=None):
            e = inner_estimate(state, confidence, ctx)
            k = scale.to(e.estimate.device)
            var = e.info["var"] * (k * k)
            est = e.estimate * k
            lo, hi = E.normal_bounds(est, var, confidence)
            return Estimate(est, lo, hi,
                            info={**e.info, "var": var, "dim_scale": k})

    return inner.with_(name=f"join-{estimator}", fused=fused, estimate=est_fn)


# ---------------------------------------------------------------------------
# Deep OLA composition — an outer estimator over the inner OLA estimate
# (port of repro/core/gla.py:531-593)
# ---------------------------------------------------------------------------

def compose(inner: GLA, outer_estimate: Callable[[Estimate, float], Estimate],
            *, name: Optional[str] = None) -> GLA:
    """Nest an outer estimator over the inner GLA's *estimate*.

    The execution scaffolding — init/accumulate/merge/terminate, the
    estimator extensions, the kernel contracts (``fused``,
    ``kernel_cols``), additivity — is the inner GLA's verbatim, so a
    composed plan rides every path the inner one does (K1 group
    included) with bitwise-equal states.  Only ``estimate`` differs: the
    inner estimate first, then ``outer_estimate(inner_est, confidence)``.
    """
    if inner.estimate is None:
        raise ValueError(
            f"compose() needs an inner GLA with an estimation model, "
            f"got {inner.name!r}")
    if inner.members:
        raise ValueError("compose() nests a single GLA, not a bundle — "
                         "bundle the composed GLAs instead")
    inner_estimate = inner.estimate

    def estimate(state, confidence, ctx=None) -> Estimate:
        return outer_estimate(inner_estimate(state, confidence, ctx), confidence)

    return inner.with_(estimate=estimate, name=name or f"compose[{inner.name}]")


_HAVING_CMPS = {">=": torch.ge, ">": torch.gt, "<=": torch.le, "<": torch.lt}


def make_having_gla(inner: GLA, threshold, *, mode: str = ">=", agg: int = 0,
                    name: Optional[str] = None) -> GLA:
    """GROUP BY + HAVING over *estimated* aggregates (the Deep OLA query
    shape): the sum of the inner group-by's per-group estimates over the
    groups whose point estimate (aggregate column ``agg``) passes
    ``estimate <mode> threshold``, with the passing groups' inner variances
    summed (:func:`estimators.nested_group_estimate`: a passing group at
    |S| <= 1 gives ±inf bounds, never NaN).  ``threshold`` is a host float
    or a 0-d tensor.  Bounds can widen for a round when a group flips."""
    if mode not in _HAVING_CMPS:
        raise ValueError(f"unknown HAVING mode {mode!r}")
    cmp = _HAVING_CMPS[mode]

    def having(est_g):
        v = est_g[..., agg] if est_g.ndim >= 2 else est_g
        return cmp(v, threshold)

    def outer(inner_est: Estimate, confidence) -> Estimate:
        return E.nested_group_estimate(inner_est, having, confidence)

    return compose(inner, outer, name=name or f"having[{inner.name}{mode}{threshold!r}]")


# ---------------------------------------------------------------------------
# Padded-slot query families — the serving layer's dynamic bundle (port of
# repro/core/gla.py:595-826; repro_torch/service.py drives them).
#
# A family fixes the query *shape* (a basis of value expressions, the
# range-predicate columns, optional group keys); each slot picks a basis
# expression and half-open ranges.  The reference makes those per-slot
# parameters dynamic jit inputs so that one compiled step serves every
# arrival; with no trace here they are host values the slot closures
# capture, and a bank of K slots is a K-member bundle that K1 steps in
# ceil(K/16) launches.  Each slot's program is built from the same
# constructors, the same predicate closure and the same d_total as the
# solo query (:meth:`SlotFamily.solo_gla`), so its states and estimates
# are bitwise a fresh solo session's over the rounds it witnessed.
# ---------------------------------------------------------------------------

_INACTIVE_LO = np.float32(np.inf)  # the empty half-open range: weight exactly 0
_INACTIVE_HI = np.float32(-np.inf)


class SlotQuery(NamedTuple):
    """One query expressible in a :class:`SlotFamily`.

    ``SUM(exprs[expr](d)) WHERE AND_j lo_j <= pred_col_j(d) < hi_j
    [GROUP BY group [HAVING est >= having]]``: ``ranges`` maps predicate
    column -> (lo, hi) half-open (columns not named are unconstrained);
    ``group`` names one of the family's group keys (None: a scalar
    aggregate); ``having`` (needs ``group``) nests the HAVING estimator
    over the group estimates (:func:`make_having_gla`).
    """

    expr: str
    ranges: Mapping[str, Tuple[float, float]] = {}
    group: Optional[str] = None
    having: Optional[float] = None


class SlotParams(NamedTuple):
    """Per-slot parameters of one bank of capacity K (host arrays; the
    reference's dynamic jit inputs).  Inactive slots carry the empty range
    (lo=+inf, hi=-inf): their predicate weight is exactly 0 on every row.
    ``hv`` is the per-slot HAVING threshold (having banks only; +inf on an
    inactive slot, so no group passes and its estimate is 0 ± 0)."""

    expr: np.ndarray  # int32 [K]: row of the family's expression basis
    lo: np.ndarray  # float32 [K, n_pred]
    hi: np.ndarray  # float32 [K, n_pred]
    fresh: np.ndarray  # bool [K]: the slot was (re)claimed since its last step
    hv: Optional[np.ndarray] = None  # float32 [K]: HAVING thresholds


def _range_cond(pred_cols: Tuple[str, ...], lo, hi):
    """Predicate closure over host float32 bounds, shared verbatim by a
    slot's in-bundle program and its solo GLA, so the 0/1 weights are
    bitwise-equal.  Unconstrained columns carry (-inf, +inf)."""
    bounds = [(float(a), float(b)) for a, b in zip(lo, hi)]

    def cond(chunk):
        w = None
        for col, (a, b) in zip(pred_cols, bounds):
            c = (chunk[col] >= a) & (chunk[col] < b)
            w = c if w is None else w & c
        if w is None:  # a family with no predicate columns
            return torch.ones_like(chunk["_mask"], dtype=_F32)
        return w.to(_F32)

    return cond


class _Basis:
    """The family's basis expressions and the bank's group key evaluated
    once per chunk dict and shared by every slot: the reference's CSE of
    the stacked basis.  A K-slot bank over one round-slice materializes
    each expression once (contiguous float32) and its group ids once
    (contiguous int32), so the kernel wrapper hands the same tensors to
    every member, not K copies.  The family's ids lie in [0, num_groups),
    so the int32 ids are the group function's own."""

    def __init__(self, fns):
        self._fns = fns
        self._cols = None
        self._vals = {}

    def _cached(self, key, make):
        def value(chunk):
            if chunk is not self._cols:  # a new slice or chunk: forget the last
                self._cols, self._vals = chunk, {}
            v = self._vals.get(key)
            if v is None:
                v = self._vals[key] = make(chunk)
            return v

        return value

    def func(self, i: int):
        fn = self._fns[i]
        return self._cached(i, lambda c: fn(c).to(_F32).contiguous())

    def group(self, gfn):
        return self._cached("group", lambda c: gfn(c).to(torch.int32).contiguous())


class SlotFamily:
    """A parametric family of slot queries over a fixed expression basis.

    Args:
      exprs: ordered mapping name -> (chunk -> [..., L] float32) value
        expressions, the basis a slot selects from.
      pred_cols: the columns range predicates may constrain.
      groups: optional mapping name -> (group_fn, num_groups) for group-by
        slots (ids already in [0, num_groups): a large domain is bucketed
        by the caller, e.g. with :func:`hash_bucket`); each group key gets
        its own bank.
    """

    def __init__(self, exprs: Mapping[str, Callable[[Chunk], torch.Tensor]],
                 pred_cols: Sequence[str],
                 groups: Optional[Mapping[str, Tuple[Callable, int]]] = None):
        self.expr_names: Tuple[str, ...] = tuple(exprs)
        self._expr_fns = tuple(exprs[n] for n in self.expr_names)
        if not self._expr_fns:
            raise ValueError("SlotFamily needs at least one basis expression")
        self.pred_cols: Tuple[str, ...] = tuple(pred_cols)
        self.groups = dict(groups or {})

    # -- host-side parameter rows -------------------------------------------

    def bank_of(self, q: SlotQuery) -> str:
        """The bank a query lands in: its group key, "scalar", or
        ``"<group>:having"`` for a nested HAVING query (same states as the
        group bank, another estimate)."""
        if q.group is not None and q.group not in self.groups:
            raise KeyError(f"unknown group key {q.group!r}; family has "
                           f"{sorted(self.groups)}")
        if q.having is not None:
            if q.group is None:
                raise ValueError(
                    "SlotQuery.having needs a group key — HAVING nests "
                    "over per-group estimates")
            return f"{q.group}:having"
        return q.group if q.group is not None else "scalar"

    def slot_row(self, q: SlotQuery):
        """Host (expr_idx, lo[n_pred], hi[n_pred]) float32 row for ``q``."""
        if q.expr not in self.expr_names:
            raise KeyError(f"unknown expression {q.expr!r}; family basis is "
                           f"{list(self.expr_names)}")
        unknown = sorted(set(q.ranges) - set(self.pred_cols))
        if unknown:
            raise KeyError(f"query constrains {unknown}, not in the "
                           f"family's pred_cols {list(self.pred_cols)}")
        lo = np.full(len(self.pred_cols), -np.inf, np.float32)
        hi = np.full(len(self.pred_cols), np.inf, np.float32)
        for j, col in enumerate(self.pred_cols):
            if col in q.ranges:
                lo[j], hi[j] = (np.float32(q.ranges[col][0]),
                                np.float32(q.ranges[col][1]))
        return self.expr_names.index(q.expr), lo, hi

    def inactive_row(self):
        """(expr_idx, lo, hi) of a parked slot: the empty range."""
        n = len(self.pred_cols)
        return (0, np.full(n, _INACTIVE_LO, np.float32),
                np.full(n, _INACTIVE_HI, np.float32))

    # -- per-slot GLA programs ----------------------------------------------

    def _member_gla(self, bank: str, func, cond, d_total: float, hv=None,
                    basis: Optional[_Basis] = None) -> GLA:
        if bank == "scalar":
            return make_sum_gla(func, cond, d_total=d_total)
        base, _, nested = bank.partition(":")
        gfn, G = self.groups[base]
        if basis is not None:
            gfn = basis.group(gfn)
        inner = make_groupby_gla(func, cond, gfn, num_groups=G, d_total=d_total)
        if nested != "having":
            return inner
        # the slot's state IS the group bank's; only the estimate nests, and
        # the threshold stays out of the name
        return make_having_gla(inner, hv, name=f"having[{base}]")

    def solo_gla(self, q: SlotQuery, *, d_total: float) -> GLA:
        """The stand-alone GLA of one slot query — what a fresh Session
        would run, and the bitwise reference of a late joiner."""
        expr_idx, lo, hi = self.slot_row(q)
        cond = _range_cond(self.pred_cols, lo, hi)
        hv = None if q.having is None else float(np.float32(q.having))
        return self._member_gla(self.bank_of(q), self._expr_fns[expr_idx], cond,
                                d_total, hv)

    def bind(self, bank: str, params: SlotParams, d_total: float) -> GLA:
        """The K-slot bundle GLA of one bank over ``params``: member k is
        slot k's program, every basis expression evaluated once per chunk
        dict for all of them, and so is a group bank's key
        (:class:`_Basis`).  Built with the uncached
        tuple combinator, never :func:`GLABundle`'s cache: the members'
        closures capture per-step parameters, so a cache would only hold
        dead closures (and their chunk) alive."""
        basis = _Basis(self._expr_fns)
        members = []
        for k in range(len(params.expr)):
            cond = _range_cond(self.pred_cols, params.lo[k], params.hi[k])
            hv = None if params.hv is None else float(params.hv[k])
            members.append(self._member_gla(bank, basis.func(int(params.expr[k])),
                                            cond, d_total, hv, basis))
        return _combine_members(tuple(members), f"slots-{bank}x{len(members)}")

    def zero_slot_state(self, bank: str, device) -> E.SumState:
        """One slot's init state, without a partition axis (the state a
        fresh or reclaimed slot starts from)."""
        if bank == "scalar":
            shape, matched = (1,), ()
        else:
            G = self.groups[bank.partition(":")[0]][1]
            shape, matched = (G, 1), (G,)
        z = partial(torch.zeros, dtype=_F32, device=device)
        return E.SumState(sum=z(shape), sumsq=z(shape), scanned=z(()), matched=z(matched))


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (and >= 1): the slot-capacity rule."""
    return 1 << max(0, int(n - 1).bit_length())
