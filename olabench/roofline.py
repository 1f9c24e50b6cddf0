"""The bytes a window's work needs, counted from the queries, and the peak.

A query needs each column it reads once a pass over its rows, and its
state read and written once a round-slice, a partition each.  What a
particular implementation reads beyond that (projected operands, padded
rows, parked slots, a column read twice) is not counted, so a share of the
peak reads the same work whatever implements the scan.
"""
from __future__ import annotations

from typing import Iterable

from olabench import queries as Q

#: H100 SXM HBM3, NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
COLUMN_BYTES = 4  # every column is 32-bit; the mask too
_EXPR_COLUMNS = {
    "revenue": {"extendedprice", "discount"},
    "sum_qty": {"quantity"},
    "sum_base_price": {"extendedprice"},
    "sum_disc_price": {"extendedprice", "discount"},
    "sum_charge": {"extendedprice", "discount", "tax"},
}
_GROUP_COLUMNS = {None: set(), "rfls": {"rfls"}, "suppkey": {"suppkey"}}


def columns(q: Q.Query) -> set:
    """The columns ``q`` reads, the mask among them."""
    cols = {"_mask", "shipdate"} | _GROUP_COLUMNS[q.group]
    for e in q.exprs:
        cols |= _EXPR_COLUMNS[e]
    if q.disc_cents is not None:
        cols.add("discount")
    if q.qty_below is not None:
        cols.add("quantity")
    return cols


def row_bytes(qs: Iterable[Q.Query]) -> int:
    """Bytes a row of a scan that serves all of ``qs`` at once."""
    cols = set()
    for q in qs:
        cols |= columns(q)
    return COLUMN_BYTES * len(cols)


def state_bytes(q: Q.Query, partitions: int) -> int:
    """A query's state, every partition's: sum, sumsq [G, A] and matched [G]."""
    return 4 * partitions * q.groups * (2 * len(q.exprs) + 1)


def pass_bytes(qs, rows: int, partitions: int, rounds: int) -> int:
    """One exact shared pass of ``qs`` over ``rows`` live rows in ``rounds``
    round-slices: the columns once, each state read and written a slice."""
    return row_bytes(qs) * rows + sum(2 * rounds * state_bytes(q, partitions) for q in qs)
