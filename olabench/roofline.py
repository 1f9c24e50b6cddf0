"""The bytes a window's work needs, counted from the queries, and the peak.

A query needs each column it reads once a pass over its rows, each
dimension column it probes once a pass, and its state read and written
once a round-slice, a partition each.  What a particular implementation
reads beyond that (projected operands, padded rows, parked slots, a column
read twice, a probe table read a row at a time) is not counted, so a share
of the peak reads the same work whatever implements the scan.
"""
from __future__ import annotations

from typing import Iterable

from olabench import queries as Q

#: H100 SXM HBM3, NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
COLUMN_BYTES = 4  # every column is 32-bit; the mask too


def columns(q) -> set:
    """The columns ``q`` reads, the mask among them: its kind's."""
    return Q.kind(q.kind).columns(q)


def probes(qs, dims) -> dict:
    """``{dimension column: bytes}`` that any of ``qs`` probes, each once."""
    out = {}
    for q in qs:
        out.update(Q.kind(q.kind).probes(q, dims))
    return out


def row_bytes(qs: Iterable[Q.Query]) -> int:
    """Bytes a row of a scan that serves all of ``qs`` at once."""
    cols = set()
    for q in qs:
        cols |= columns(q)
    return COLUMN_BYTES * len(cols)


def state_bytes(q: Q.Query, partitions: int) -> int:
    """A query's state, every partition's: sum, sumsq [G, A] and matched [G]."""
    return 4 * partitions * q.groups * (2 * len(q.exprs) + 1)


def pass_bytes(qs, rows: int, partitions: int, rounds: int, dims=None) -> int:
    """One exact shared pass of ``qs`` over ``rows`` live rows in ``rounds``
    round-slices: the columns once, each dimension column probed once (of
    ``dims``, the cell's dimension tables), each state read and written a
    slice."""
    probed = sum(probes(qs, {} if dims is None else dims).values())
    return (row_bytes(qs) * rows + probed
            + sum(2 * rounds * state_bytes(q, partitions) for q in qs))
