"""The plain reference: the queries' sums and the estimator, in float64.

It imports nothing of the program.  It takes the benchmark's own generated
columns (``data.generate``) and the layout rebuilt from the seed
(``data.Layout``), never the port's randomized or packed tensors, and
works out for each query its exact answer over a set of rows, and the
single-estimator model's estimate and bounds (paper Eq. 2 and Eq. 4; the
Horvitz-Thompson scale-up of a sample without replacement, its unbiased
variance, normal bounds at the configuration's confidence).

``precision`` is ``"float64"`` for the reference and ``"bfloat16"`` for the
control: the same code with the float columns and each row's value in
bfloat16 (the step below the configuration's float32), summed in float64.

A query's sums are its kind's (``queries.Kind.sums``): :func:`table_sums`
for Q1, Q6 and Q15; a kind that probes dimension tables gets them as well
and may sum through :func:`accumulate`.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, NamedTuple

import torch

from olabench import queries as Q

_F64 = torch.float64


class Sums(NamedTuple):
    """A query's sums over a set of rows: ``sum``/``sumsq`` [G, A] over the
    rows its predicate keeps, ``matched`` [G], ``scanned`` every row."""

    sum: torch.Tensor
    sumsq: torch.Tensor
    matched: torch.Tensor
    scanned: int

    def __add__(self, o: "Sums") -> "Sums":
        return Sums(self.sum + o.sum, self.sumsq + o.sumsq, self.matched + o.matched,
                    self.scanned + o.scanned)


def _values(cols: Dict[str, torch.Tensor], exprs, dtype) -> torch.Tensor:
    ep, dc = cols["extendedprice"].to(dtype), cols["discount"].to(dtype)
    one = torch.ones((), dtype=dtype, device=ep.device)
    out = []
    for e in exprs:
        if e == "revenue":
            v = ep * dc
        elif e == "sum_qty":
            v = cols["quantity"].to(dtype)
        elif e == "sum_base_price":
            v = ep
        elif e == "sum_disc_price":
            v = ep * (one - dc)
        elif e == "sum_charge":
            v = ep * (one - dc) * (one + cols["tax"].to(dtype))
        else:
            raise ValueError(f"unknown expression {e!r}")
        out.append(v.to(_F64))
    return torch.stack(out, dim=-1)


#: the reference's and the control's precision
DTYPES = {"float64": _F64, "bfloat16": torch.bfloat16}


def _keep(cols: Dict[str, torch.Tensor], q: Q.Query, dtype) -> torch.Tensor:
    sd = cols["shipdate"]
    keep = (sd >= q.ship[0]) & (sd < q.ship[1])
    if q.disc_cents is not None:
        cents = torch.round(cols["discount"].to(dtype).to(_F64) * 100.0)
        keep &= (cents >= q.disc_cents[0]) & (cents <= q.disc_cents[1])
    if q.qty_below is not None:
        keep &= cols["quantity"].to(dtype).to(_F64) < q.qty_below
    return keep


def sums(cols: Dict[str, torch.Tensor], q, precision: str = "float64", dims=None) -> Sums:
    """``q``'s sums over the rows of ``cols``, by its kind; ``dims`` are the
    cell's dimension tables (``tables.py``)."""
    return Q.kind(q.kind).sums(cols, q, precision, {} if dims is None else dims)


def table_sums(cols: Dict[str, torch.Tensor], q: Q.Query, precision: str = "float64") -> Sums:
    """A Q1, Q6 or Q15 query's sums: its predicate and values on ``cols``."""
    dtype = DTYPES[precision]
    gid = None if q.group is None else cols[q.group].long()
    return accumulate(_values(cols, q.exprs, dtype), _keep(cols, q, dtype), gid, q.groups)


def accumulate(vals: torch.Tensor, keep: torch.Tensor, gid, groups: int) -> Sums:
    """Sums of the float64 values ``vals`` [n, A] over the rows ``keep``
    holds, by the group ids ``gid`` [n] (None: one group)."""
    vals = vals * keep[:, None]
    n, A = vals.shape
    w = keep.to(_F64)
    if gid is None:
        return Sums(vals.sum(0)[None], (vals * vals).sum(0)[None], w.sum()[None], n)
    s = torch.zeros((groups, A), dtype=_F64, device=vals.device)
    sq = torch.zeros_like(s)
    m = torch.zeros((groups,), dtype=_F64, device=vals.device)
    s.index_add_(0, gid, vals)
    sq.index_add_(0, gid, vals * vals)
    m.index_add_(0, gid, w)
    return Sums(s, sq, m, n)


def zero(q: Q.Query, device) -> Sums:
    z = torch.zeros((q.groups, len(q.exprs)), dtype=_F64, device=device)
    return Sums(z, z.clone(), torch.zeros((q.groups,), dtype=_F64, device=device), 0)


class Estimate(NamedTuple):
    estimate: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor


def estimate(s: Sums, d_total: int, confidence: float) -> Estimate:
    """Paper Eq. (2) and (4): X = D/S·Σ, Var = D(D-S)/(S²(S-1))·(S·Σq - Σ²),
    bounds X ± z·√Var with P(|Z| ≤ z) = confidence; infinite below 2 rows."""
    S, D = float(s.scanned), float(d_total)
    est = D / max(S, 1.0) * s.sum
    if S < 2:
        var = torch.full_like(est, math.inf)
    else:
        var = D * max(D - S, 0.0) / (S * S * (S - 1.0)) * torch.clamp(
            S * s.sumsq - s.sum * s.sum, min=0.0)
    z = NormalDist().inv_cdf((1.0 + confidence) / 2.0)
    half = z * torch.sqrt(var)
    return Estimate(est, est - half, est + half)


def gap(port, ref: torch.Tensor) -> float:
    """The widest gap of ``port`` from ``ref``, a cell at a time, against
    the larger of that cell's |ref| and the median |ref| of the whole
    answer (so that a group all but empty does not read its rounding as a
    fault).  Cells that are 0 on both sides read 0; NaN reads inf."""
    p = torch.as_tensor(port).to(device=ref.device, dtype=_F64).reshape(ref.shape)
    r = ref.to(_F64)
    diff = torch.nan_to_num((p - r).abs(), nan=math.inf)
    if not bool(torch.isfinite(p).all()) and bool(torch.isfinite(r).all()):
        return math.inf
    finite = torch.isfinite(r)
    diff = torch.where(finite, diff, torch.where(p == r, 0.0, math.inf))
    mag = r.abs().where(finite, torch.zeros_like(r))
    floor = float(mag.flatten().median()) if mag.numel() else 0.0
    den = torch.clamp(mag, min=floor)
    out = torch.where(diff == 0, torch.zeros_like(diff), diff / den)
    return float(out.max()) if out.numel() else 0.0
