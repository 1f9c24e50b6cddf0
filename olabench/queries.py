"""TPC-H Q6, Q1 and Q15 with the specification's substitution parameters.

TPC-H 3.0.1 §2.4.6 (Q6): DATE the first of January of a year in 1993-1997,
DISCOUNT in 0.02-0.09 (the window DISCOUNT ± 0.01, inclusive), QUANTITY 24
or 25 (``l_quantity < QUANTITY``).  §2.4.1 (Q1): DELTA in 60-120 days
(``l_shipdate <= date '1998-12-01' - DELTA``), its four sums grouped by
returnflag and linestatus.  §2.4.15 (Q15): the view ``revenue0``,
``SUM(l_extendedprice * (1 - l_discount))`` by ``l_suppkey`` over the three
months from DATE, the first of a month in 1993-01 .. 1997-10.  Day numbers
are the generator's: day 0 is 1992-01-02, day 2525 is 1998-12-01.

A :class:`Query` is plain data.  The program gets it as the port's own
query objects (:func:`port_gla` for ``engine.run_queries``,
:func:`port_slots` for ``service.OLAService``); the reference evaluates the
same predicate on integer days and cents (``reference.py``).

Every query kind a traffic mix names is looked up in :data:`KINDS`, where
Q1, Q6 and Q15 register below; a traffic file's ``query_modules`` names
further modules under ``olabench``, each registering its kinds when
imported (:func:`load`), so a later cell brings a kind as a new file.
"""
from __future__ import annotations

import importlib
from datetime import date
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

BASE = date(1992, 1, 2)
SHIP_LAST = (date(1998, 12, 1) - BASE).days  # 2525
Q6_YEARS = tuple(range(1993, 1998))
Q6_DISCOUNT_CENTS = tuple(range(2, 10))
Q6_QUANTITIES = (24, 25)
Q1_DELTAS = tuple(range(60, 121))
#: Q15's DATE: the first of each month from 1993-01 to 1997-10
Q15_MONTHS = tuple((y, m) for y in range(1993, 1998) for m in range(1, 13)
                   if (y, m) <= (1997, 10))
#: Q1's four sums, in the order ``q1`` members stack them
Q1_SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge")
EXPRS = ("revenue",) + Q1_SUMS


def day(y: int, m: int = 1, d: int = 1) -> int:
    return (date(y, m, d) - BASE).days


class Query(NamedTuple):
    """``SUM(exprs) WHERE ship_lo <= shipdate < ship_hi [AND disc_lo_cent <=
    100·discount <= disc_hi_cent AND quantity < qty_below] [GROUP BY group]``
    over ``groups`` groups; ``exprs`` names of :data:`EXPRS`."""

    kind: str  # one of KINDS
    exprs: Tuple[str, ...]
    ship: Tuple[int, int]
    disc_cents: Optional[Tuple[int, int]] = None
    qty_below: Optional[int] = None
    group: Optional[str] = None  # None, "rfls" or "suppkey"
    groups: int = 1


def q6(rng: np.random.Generator) -> Query:
    y = int(rng.choice(Q6_YEARS))
    c = int(rng.choice(Q6_DISCOUNT_CENTS))
    return Query("q6", ("revenue",), (day(y), day(y + 1)), (c - 1, c + 1),
                 int(rng.choice(Q6_QUANTITIES)))


def q1(rng: np.random.Generator) -> Query:
    delta = int(rng.choice(Q1_DELTAS))
    return Query("q1", Q1_SUMS, (0, SHIP_LAST + 1 - delta), group="rfls", groups=4)


def q15(rng: np.random.Generator, suppliers: int) -> Query:
    y, m = Q15_MONTHS[int(rng.integers(len(Q15_MONTHS)))]
    y2, m2 = (y, m + 3) if m <= 9 else (y + 1, m - 9)
    return Query("q15", ("sum_disc_price",), (day(y, m), day(y2, m2)), group="suppkey",
                 groups=int(suppliers))


# --- the kinds ----------------------------------------------------------------

class Kind(NamedTuple):
    """What the harness needs of a query kind, five functions.

    ``draw(rng, config)``: one query with fresh substitution parameters,
    drawn by ``rng`` alone, sized by the configuration.  ``port_gla(query,
    d_total, dims)``: the query as one of the port's GLAs, given the cell's
    dimension tables (its table module's ``dimensions``, on the device).
    ``sums(cols, query, precision, dims)``: the plain reference's
    ``reference.Sums`` over the rows of ``cols``, in float64, or with
    ``precision`` "bfloat16" the control's.  ``columns(query)``: the
    scanned table's columns it reads, the mask among them.
    ``probes(query, dims)``: ``{dimension column: bytes}`` it probes.  A
    kind's query is a NamedTuple with at least ``kind`` (the name it is
    registered under), ``exprs`` and ``groups``: its sums are
    ``[groups, len(exprs)]``."""

    draw: Callable
    port_gla: Callable
    sums: Callable
    columns: Callable
    probes: Callable


#: the registered kinds by name
KINDS: Dict[str, Kind] = {}


def register(name: str, kind: Kind) -> None:
    """Register ``kind`` under ``name``; a name is never given a second kind."""
    if KINDS.setdefault(name, kind) is not kind:
        raise ValueError(f"query kind {name!r} is registered already")


def kind(name: str) -> Kind:
    if name not in KINDS:
        raise ValueError(f"unknown query {name!r}: {sorted(KINDS)}")
    return KINDS[name]


def load(modules) -> None:
    """Import the modules of kinds a traffic file names (``query_modules``),
    each a module under ``olabench`` that registers its kinds."""
    for m in modules:
        if not m.startswith("olabench."):
            raise ValueError(f"query module {m!r} is not under olabench")
        importlib.import_module(m)


def draw(rng: np.random.Generator, name: str, config: dict):
    """One query of kind ``name`` with fresh substitution parameters."""
    return kind(name).draw(rng, config)


# --- the program's side -----------------------------------------------------

def _value_fns():
    def revenue(c):
        return c["extendedprice"] * c["discount"]

    def disc_price(c):
        return c["extendedprice"] * (1 - c["discount"])

    return {
        "revenue": revenue,
        "sum_qty": lambda c: c["quantity"],
        "sum_base_price": lambda c: c["extendedprice"],
        "sum_disc_price": disc_price,
        "sum_charge": lambda c: disc_price(c) * (1 + c["tax"]),
    }


def _ranges(q: Query) -> dict:
    """Half-open float ranges of the query's predicate, a column each."""
    r = {"shipdate": (float(q.ship[0]), float(q.ship[1]))}
    if q.disc_cents is not None:  # half a cent of room: the values are k/100 in f32
        r["discount"] = ((q.disc_cents[0] - 0.5) / 100.0, (q.disc_cents[1] + 0.5) / 100.0)
    if q.qty_below is not None:
        r["quantity"] = (0.0, float(q.qty_below))
    return r


def port_gla(q: Query, d_total: float, dims=None):
    """The query as one of the port's GLAs (``repro_torch.gla``); these
    kinds probe no dimension table, so ``dims`` goes unused."""
    import torch

    import repro_torch as T

    fns = _value_fns()
    ranges = _ranges(q)

    def cond(c):
        w = None
        for col, (lo, hi) in ranges.items():
            m = (c[col] >= lo) & (c[col] < hi)
            w = m if w is None else w & m
        return w.to(torch.float32)

    if len(q.exprs) == 1:
        func = fns[q.exprs[0]]
    else:
        sel = [fns[e] for e in q.exprs]

        def func(c):
            return torch.stack([f(c) for f in sel], dim=-1)

    if q.group is None:
        return T.make_sum_gla(func, cond, d_total=d_total, num_aggs=len(q.exprs))
    col = q.group
    return T.make_groupby_gla(func, cond, lambda c: c[col], num_groups=q.groups,
                              d_total=d_total, num_aggs=len(q.exprs))


def port_family(suppliers: int):
    """The analysts' slot family (``repro_torch.gla.SlotFamily``): one basis
    expression a slot, range predicates on shipdate, discount and quantity,
    and the two group keys."""
    import repro_torch as T

    return T.SlotFamily(exprs=_value_fns(), pred_cols=("shipdate", "discount", "quantity"),
                        groups={"rfls": (lambda c: c["rfls"], 4),
                                "suppkey": (lambda c: c["suppkey"], int(suppliers))})


def slot_queries(q: Query) -> list:
    """The query as the slots that answer it: one a sum (a slot sums one
    expression), each the query itself with that sum alone."""
    return [q._replace(exprs=(e,)) for e in q.exprs]


def port_slot(q: Query):
    import repro_torch as T

    if len(q.exprs) != 1:
        raise ValueError("a slot query sums one expression")
    return T.SlotQuery(q.exprs[0], _ranges(q), group=q.group)


# --- Q1, Q6 and Q15 as kinds ----------------------------------------------------

_EXPR_COLUMNS = {
    "revenue": {"extendedprice", "discount"},
    "sum_qty": {"quantity"},
    "sum_base_price": {"extendedprice"},
    "sum_disc_price": {"extendedprice", "discount"},
    "sum_charge": {"extendedprice", "discount", "tax"},
}
_GROUP_COLUMNS = {None: set(), "rfls": {"rfls"}, "suppkey": {"suppkey"}}


def table_columns(q: Query) -> set:
    """The columns ``q`` reads, the mask among them."""
    cols = {"_mask", "shipdate"} | _GROUP_COLUMNS[q.group]
    for e in q.exprs:
        cols |= _EXPR_COLUMNS[e]
    if q.disc_cents is not None:
        cols.add("discount")
    if q.qty_below is not None:
        cols.add("quantity")
    return cols


def _table_sums(cols, q: Query, precision: str, dims):
    from olabench import reference  # which imports this module

    return reference.table_sums(cols, q, precision)


def _no_probes(q: Query, dims) -> dict:
    return {}


register("q6", Kind(lambda rng, config: q6(rng), port_gla, _table_sums, table_columns,
                    _no_probes))
register("q1", Kind(lambda rng, config: q1(rng), port_gla, _table_sums, table_columns,
                    _no_probes))
register("q15", Kind(lambda rng, config: q15(rng, int(config["suppliers"])), port_gla,
                     _table_sums, table_columns, _no_probes))
