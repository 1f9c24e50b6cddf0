"""TPC-H Q10 and Q14 over lineitem joined with the replicated ORDERS and PART
of ``join_tables.py``, with the specification's substitution parameters.

§2.4.10 (Q10): revenue, ``SUM(l_extendedprice * (1 - l_discount))``, by
``c_custkey`` over the lines with ``l_returnflag = 'R'`` of the orders placed
in the three months from DATE, the first of a month from 1993-02 to 1995-01.
Every customer is a group (15,000,000 at SF 100); the top 20 and the
customers' names and addresses are the caller's, so the check compares
every group's revenue.  §2.4.14 (Q14): the same revenue over the lines
shipped in the month from DATE, the first of a month in 1993-1997, in 2
groups by the part's P_TYPE: PROMO% (group 1) and the rest (group 0);
``promo_revenue`` is 100 · group 1 / (group 0 + group 1).

The port gets each as a join group-by over a replicated dimension
(``gla.make_join_groupby_gla``, paper Alg. 4): Q10 probes ORDERS by the
dense order number (``join_tables.dense_order``), its date window the
dimension's predicate; Q14 probes PART by ``l_partkey``.  The reference
joins in plain float64 PyTorch, and finds a line's order by
``torch.searchsorted`` over the orders' sparse keys, not by the port's
hash.  Importing the module registers both kinds (``queries.KINDS``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from olabench import data, queries as Q, reference as REF
from olabench.join_tables import dense_order

#: Q10's DATE: the first of each month from 1993-02 to 1995-01
Q10_MONTHS = tuple((y, m) for y in range(1993, 1996) for m in range(1, 13)
                   if (1993, 2) <= (y, m) <= (1995, 1))
#: Q14's DATE: the first of each month in 1993-1997
Q14_MONTHS = tuple((y, m) for y in range(1993, 1998) for m in range(1, 13))
RETURNED = data.RFLS.index("RF")  # l_returnflag = 'R' (linestatus F by the spec's rules)


class JoinQuery(NamedTuple):
    """``SUM(exprs) WHERE dates[0] <= <the kind's date> < dates[1]`` over the
    join, by ``groups`` groups: the order's date for Q10 (and the line
    returned), the line's shipdate for Q14."""

    kind: str
    exprs: Tuple[str, ...]
    dates: Tuple[int, int]
    groups: int


def _months_later(y: int, m: int, k: int) -> Tuple[int, int]:
    m += k
    return y + (m - 1) // 12, (m - 1) % 12 + 1


def _window(months, rng: np.random.Generator, k: int) -> Tuple[int, int]:
    y, m = months[int(rng.integers(len(months)))]
    return Q.day(y, m), Q.day(*_months_later(y, m, k))


def q10(rng: np.random.Generator, config: dict) -> JoinQuery:
    return JoinQuery("q10", ("sum_disc_price",), _window(Q10_MONTHS, rng, 3),
                     int(config["customers"]))


def q14(rng: np.random.Generator, config: dict) -> JoinQuery:
    return JoinQuery("q14", ("sum_disc_price",), _window(Q14_MONTHS, rng, 1), 2)


# --- the program's side -----------------------------------------------------

def _disc_price(c):
    return c["extendedprice"] * (1 - c["discount"])


def q10_gla(q: JoinQuery, d_total: float, dims):
    import repro_torch as T

    lo, hi = q.dates
    od = dims["o_orderdate"]
    return T.make_join_groupby_gla(
        _disc_price, lambda c: (c["rfls"] == RETURNED).to(torch.float32),
        lambda c: dense_order(c["orderkey"]), dims["o_custkey"], (od >= lo) & (od < hi),
        num_groups=q.groups, d_total=d_total, device=od.device)


def q14_gla(q: JoinQuery, d_total: float, dims):
    import repro_torch as T

    lo, hi = q.dates
    promo = dims["p_promo"]
    return T.make_join_groupby_gla(
        _disc_price,
        lambda c: ((c["shipdate"] >= lo) & (c["shipdate"] < hi)).to(torch.float32),
        lambda c: c["partkey"], promo, torch.ones(promo.shape, dtype=torch.bool,
                                                  device=promo.device),
        num_groups=q.groups, d_total=d_total, device=promo.device)


# --- the reference's side -----------------------------------------------------

def _revenue(cols, precision: str) -> torch.Tensor:
    dt = REF.DTYPES[precision]
    ep, dc = cols["extendedprice"].to(dt), cols["discount"].to(dt)
    return (ep * (torch.ones((), dtype=dt, device=ep.device) - dc)).to(torch.float64)[:, None]


def q10_sums(cols, q: JoinQuery, precision: str, dims) -> REF.Sums:
    """Each line's order found by binary search over the orders' sparse
    keys, in order of their dense numbers."""
    od, cust = dims["o_orderdate"], dims["o_custkey"]
    keys = data.sparse_orderkey(torch.arange(od.numel(), device=od.device))
    line = cols["orderkey"].long()
    at = torch.searchsorted(keys, line).clamp(max=od.numel() - 1)
    if not bool((keys[at] == line).all()):
        raise ValueError("a line's orderkey names no order of ORDERS")
    when = od[at]
    keep = (cols["rfls"] == RETURNED) & (when >= q.dates[0]) & (when < q.dates[1])
    return REF.accumulate(_revenue(cols, precision), keep, cust[at].long(), q.groups)


def q14_sums(cols, q: JoinQuery, precision: str, dims) -> REF.Sums:
    sd = cols["shipdate"]
    keep = (sd >= q.dates[0]) & (sd < q.dates[1])
    promo = dims["p_promo"][cols["partkey"].long()].long()
    return REF.accumulate(_revenue(cols, precision), keep, promo, q.groups)


_READS = {"_mask", "extendedprice", "discount"}


def q10_probes(q, dims) -> dict:
    return {k: dims[k].numel() * dims[k].element_size() for k in ("o_custkey", "o_orderdate")}


def q14_probes(q, dims) -> dict:
    return {"p_promo": dims["p_promo"].numel() * dims["p_promo"].element_size()}


Q.register("q10", Q.Kind(q10, q10_gla, q10_sums, lambda q: _READS | {"orderkey", "rfls"},
                         q10_probes))
Q.register("q14", Q.Kind(q14, q14_gla, q14_sums, lambda q: _READS | {"shipdate", "partkey"},
                         q14_probes))
