"""Sampling estimators for parallel on-line aggregation — paper §4.

Port of ``repro/core/estimators.py:40-176,192-266``: the generic sampling-without-
replacement estimator (Eq. 2) with its unbiased variance estimator (Eq. 4),
the single-estimator model (paper Alg. 1, corrected: ``scanned`` = |S|
counts every live item, ``sum``/``sumsq`` only predicate matches), the
multiple-estimators (stratified) model (paper Alg. 2, :class:`MultState`),
the Deep OLA nested HAVING estimate (:func:`nested_group_estimate`) and the
post-hoc :func:`monotone_envelope` of per-round bounds.

The functions broadcast: ``scanned`` may carry fewer trailing axes than
``sum_`` (one count per round or partition against ``[..., A]`` or
``[..., G, A]`` sums) and is aligned to it on the right.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.uda import Estimate


class SumState(NamedTuple):
    """State of the generic sampling estimator (corrected paper Alg. 1).

    sum     = sum of func(d) over scanned, predicate-matching items
    sumsq   = sum of func(d)^2 over scanned, predicate-matching items
    scanned = |S|, number of scanned (live) items — predicate-independent
    matched = number of scanned items matching the predicate
    """

    sum: torch.Tensor
    sumsq: torch.Tensor
    scanned: torch.Tensor
    matched: torch.Tensor


def _align(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device, padded with trailing unit
    axes so that it broadcasts against ``like`` from the left."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x.reshape(tuple(x.shape) + (1,) * (like.ndim - x.ndim))


def zq(confidence) -> torch.Tensor:
    """Two-sided z quantile: P(|Z| <= zq) = confidence (float32)."""
    conf = torch.as_tensor(confidence, dtype=torch.float64)
    return torch.special.ndtri((1.0 + conf) / 2.0).to(torch.float32)


def horvitz_estimate(sum_, scanned, d_total):
    """Paper Eq. (2): X = |D|/|S| * sum_{s in S, cond} func(s)."""
    sum_ = torch.as_tensor(sum_)
    safe_s = torch.clamp(_align(scanned, sum_), min=1.0)
    return d_total / safe_s * sum_


def variance_estimate(sum_, sumsq, scanned, d_total):
    """Paper Eq. (4) — unbiased estimator of Var(X) from the sample.

    Est = |D|(|D|-|S|) / (|S|^2 (|S|-1)) * (|S| * sumsq - sum^2)

    With fewer than two scanned items the variance is undefined: the result
    is ``+inf`` (an infinite bound), never NaN.
    """
    sum_ = torch.as_tensor(sum_)
    sumsq = torch.as_tensor(sumsq, dtype=sum_.dtype, device=sum_.device)
    s = _align(scanned, sum_)
    d = torch.as_tensor(d_total, dtype=sum_.dtype, device=sum_.device)
    safe = torch.clamp(s, min=2.0)
    num = d * torch.clamp(d - s, min=0.0)
    den = safe * safe * (safe - 1.0)
    est = num / den * torch.clamp(s * sumsq - sum_ * sum_, min=0.0)
    return torch.where(s >= 2.0, est, torch.full_like(est, math.inf))


def normal_bounds(est, var, confidence):
    half = zq(confidence).to(var.device) * torch.sqrt(var)
    return est - half, est + half


def single_estimate(state: SumState, confidence, *, d_total) -> Estimate:
    """Paper Alg. 1 (GLASum-SingleEstimator) over the *merged* state.

    Valid at arbitrary per-partition progress given global randomization.
    """
    est = horvitz_estimate(state.sum, state.scanned, d_total)
    var = variance_estimate(state.sum, state.sumsq, state.scanned, d_total)
    lo, hi = normal_bounds(est, var, confidence)
    frac = state.scanned / max(float(d_total), 1.0)
    return Estimate(est, lo, hi, info={"var": var, "frac": frac})


class MultState(NamedTuple):
    """State of the multiple-estimators (stratified) model — paper Alg. 2.

    ``base`` accumulates locally; ``(est, estvar)`` are produced by
    EstimatorTerminate at each partition and summed by EstimatorMerge.
    """

    base: SumState
    est: torch.Tensor
    estvar: torch.Tensor


def mult_state_zero(device=None, dtype=torch.float32) -> MultState:
    z = torch.zeros((), dtype=dtype, device=device)
    return MultState(SumState(z, z.clone(), z.clone(), z.clone()), z.clone(), z.clone())


def mult_estimator_terminate(state: MultState, *, d_local) -> MultState:
    """Paper Alg. 2 EstimatorTerminate: the local estimator of partition i.

    est_i    = |D_i|/count * sum
    estvar_i = |D_i|(|D_i|-count)/(count^2(count-1)) * (count*sumSq - sum^2)

    ``d_local`` is one |D_i| per partition, aligned to the state's leading
    axes (``[P]`` against ``[P, ...]`` or ``[P, R, ...]`` states).  A
    partition with fewer than two scanned rows gets ``+inf`` variance, never
    NaN (:func:`variance_estimate`'s clamps).
    """
    b = state.base
    d = _align(d_local, b.sum)
    est = horvitz_estimate(b.sum, b.scanned, d)
    var = variance_estimate(b.sum, b.sumsq, b.scanned, d)
    return MultState(b, est, var)


def mult_estimator_merge(a: MultState, b: MultState) -> MultState:
    """Paper Alg. 2 EstimatorMerge: sum the local estimators and variances."""
    return MultState(
        base=SumState(*(x + y for x, y in zip(a.base, b.base))),
        est=a.est + b.est,
        estvar=a.estvar + b.estvar,
    )


def mult_estimate(state: MultState, confidence) -> Estimate:
    lo, hi = normal_bounds(state.est, state.estvar, confidence)
    return Estimate(state.est, lo, hi, info={"var": state.estvar})


def join_scale(d_fact, s_fact, d_dim, s_dim):
    """§3.3 multiplicative join estimator scale: (|R|/|S_R|)·(|T|/|S_T|).

    With the dimension side fully resident (``s_dim == d_dim``, the probe
    table joins) the second factor is exactly 1 and the scale is the plain
    Horvitz–Thompson |R|/|S_R|.  Denominators are clamped at 1.
    """
    xs = [torch.as_tensor(x) for x in (d_fact, s_fact, d_dim, s_dim)]
    dev = next((x.device for x in xs if x.device.type != "cpu"), xs[0].device)
    d_f, s_f, d_d, s_d = (x.to(dev, torch.float32) for x in xs)
    return d_f / torch.clamp(s_f, min=1.0) * (d_d / torch.clamp(s_d, min=1.0))


def nested_group_estimate(inner: Estimate, having, confidence) -> Estimate:
    """Deep OLA nested aggregate: SUM over the groups whose *estimated*
    inner aggregate passes a HAVING predicate (port of
    ``repro/core/estimators.py:205-233``).

    ``inner`` holds per-group arrays (estimate/lower/upper ``[..., G, A]``
    or ``[G]``, with ``info["var"]`` alike); ``having`` maps the inner
    point estimates to a 0/1 keep mask ``[..., G]``.  The outer estimate
    sums the passing groups' inner estimates and its variance their inner
    variances (independent strata: each group's state comes from disjoint
    rows).  A passing group with |S| <= 1 carries +inf inner variance and
    poisons the outer bounds to ±inf, never NaN: the mask is applied with
    ``torch.where`` (0 · inf is NaN under IEEE multiply), and the point
    estimate stays finite.
    """
    est_g = inner.estimate
    keep = having(est_g).to(est_g.dtype)
    var_g = inner.info["var"] if isinstance(inner.info, dict) else inner.info
    if keep.ndim < est_g.ndim:  # [..., G] mask over [..., G, A] estimates
        keep = keep.unsqueeze(-1)
    axis = -2 if est_g.ndim >= 2 else -1  # the group axis
    zero = torch.zeros((), dtype=est_g.dtype, device=est_g.device)
    est = torch.where(keep > 0, est_g, zero).sum(dim=axis)
    var = torch.where(keep > 0, var_g, zero).sum(dim=axis)
    if est.ndim and est.shape[-1] == 1:
        est, var = est[..., 0], var[..., 0]
    lo, hi = normal_bounds(est, var, confidence)
    return Estimate(est, lo, hi, info={"var": var, "keep": keep, "inner_var": var_g})


def _running(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """Running max (``largest``) or min along dim 0, with the reference's
    order on zeros: ``torch.cummax``/``cummin`` keep the later of two equal
    values, so 0.0 then -0.0 would end at -0.0, where jax's running maximum
    (IEEE 754 maximum) keeps 0.0 once it has seen one and its minimum keeps
    -0.0."""
    if largest:
        v = torch.cummax(x, dim=0).values
        flag = (x == 0) & ~torch.signbit(x)
    else:
        v = torch.cummin(x, dim=0).values
        flag = (x == 0) & torch.signbit(x)
    seen = torch.cumsum(flag.to(torch.int32), dim=0) > 0
    return torch.where((v == 0) & seen, v.abs() if largest else -v.abs(), v)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` with subnormals flushed to a zero of their sign, as XLA's CPU
    arithmetic reads and writes them (a compare sees -1.6e-42 as -0.0)."""
    if not x.is_floating_point():
        return x
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, torch.copysign(torch.zeros_like(x), x), x)


def monotone_envelope(lower, upper):
    """Running intersection of per-round confidence intervals.

    OLA UIs want bounds that only tighten; raw per-round CIs can widen
    transiently when a HAVING predicate flips a group in or out of the
    outer sum.  Each round's CI holds at the stated confidence, so their
    running intersection [cummax(lo), cummin(hi)] along the round axis
    (dim 0) is a valid, conservative envelope that never widens.  A round
    whose CI is disjoint from the intersection so far crosses the running
    bounds (cummax(lo) > cummin(hi)); since they only drift further apart
    from there, the envelope freezes at the last consistent round, and a
    crossing at round 0 collapses to that round's midpoint.  Applied
    post-hoc, never inside the runtime, where it would change published
    bounds.

    ``lower``/``upper`` are numpy arrays or tensors ``[R, ...]``; the
    result is a pair of tensors on the input's device, in its dtype.

    Subnormal bounds are read as the reference's compiled CPU code reads
    them, flushed to a zero of their sign: over several rounds the running
    bounds come out flushed; a single round passes through bit for bit
    (there is no running bound to compute), and its bounds cross only if
    they do once flushed — ``[0, -1.6e-42]`` does not.
    """
    lo, hi = torch.as_tensor(lower), torch.as_tensor(upper)
    if lo.shape[0] > 1:
        lo, hi = _running(_flush(lo), largest=True), _running(_flush(hi), largest=False)
    crossed = _flush(lo) > _flush(hi)  # monotone along rounds: a suffix
    idx = torch.argmax(crossed.to(torch.int32), dim=0)  # first crossed round
    prev = torch.clamp(idx - 1, min=0)[None]
    frozen_lo = torch.take_along_dim(lo, prev, dim=0)[0]
    frozen_hi = torch.take_along_dim(hi, prev, dim=0)[0]
    mid0 = _flush(0.5 * (_flush(lo[0]) + _flush(hi[0])))
    frozen_lo = torch.where(idx > 0, frozen_lo, mid0)
    frozen_hi = torch.where(idx > 0, frozen_hi, mid0)
    return (torch.where(crossed, frozen_lo, lo),
            torch.where(crossed, frozen_hi, hi))
