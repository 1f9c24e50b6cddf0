"""Shared scan/merge core — port of ``repro/core/scan.py:70-192,483-556,575-588``.

Where the reference ``vmap``s a per-partition scan, the partition axis is
written out here: columns are ``[P, C, L]`` and every state leaf carries a
leading ``P`` (and, with ``lanes > 1``, a lane axis after it).  Chunks are
folded in order by a Python loop — the reference's ``lax.scan`` — so
round-boundary states keep the chunk-sequential association.

Scan variants (selected by the engine's ``emit``):

  ``scan_prefix``          every prefix state [P, C+1, ...]; small states,
                           arbitrary snapshot schedules.
  ``scan_rounds``          state only at round boundaries [P, R, ...];
                           uniform schedules (C % R == 0).
  ``fused_rounds_states``  one K1 launch per round-slice (all partitions);
                           group states on ``emit="kernel"``.
  ``fused_prefix_states``  one K2 launch for the whole data; scalar states
                           on ``emit="kernel"``.

``scan_round_step`` and ``fused_round_step`` are also the session's
per-round-slice primitives (``repro_torch.session``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.kernels import fused_agg
from repro_torch.uda import GLA, tree_map, tree_stack

Pytree = Any


# ---------------------------------------------------------------------------
# lane (work-unit) handling
# ---------------------------------------------------------------------------

def stack_init(gla: GLA, batch: Tuple[int, ...], device) -> Pytree:
    """Initial state broadcast to leading axes ``batch`` (a view; states are
    never updated in place)."""
    return tree_map(lambda x: x.expand(*batch, *x.shape), gla.init(device))


def fold_merge(merge, states: Pytree, n: int, dim: int = 0) -> Pytree:
    """Left-fold ``merge`` over axis ``dim`` of length ``n``."""
    acc = tree_map(lambda x: x.select(dim, 0), states)
    for i in range(1, n):
        acc = merge(acc, tree_map(lambda x, i=i: x.select(dim, i), states))
    return acc


def accumulate_chunk(gla: GLA, states: Pytree, chunk: dict, lanes: int):
    """Advance per-partition states by one chunk ({name: [P, L]}); return
    (states, lane-merged view).  With ``lanes > 1`` the states are
    [P, lanes, ...] and each lane takes a contiguous L/lanes of the rows."""
    if lanes == 1:
        st = gla.accumulate(states, chunk)
        return st, st
    lc = {k: v.reshape(v.shape[0], lanes, -1) for k, v in chunk.items()}
    st = gla.accumulate(states, lc)
    return st, fold_merge(gla.merge, st, lanes, dim=1)


def _batch(P: int, lanes: int) -> Tuple[int, ...]:
    return (P,) if lanes == 1 else (P, lanes)


# ---------------------------------------------------------------------------
# per-partition scans (partition axis batched)
# ---------------------------------------------------------------------------

def scan_prefix(gla: GLA, cols: dict, lanes: int):
    """Scan chunks emitting every prefix state (init prepended).

    Returns ``(final view [P, ...], prefixes [P, C+1, ...])``."""
    P, C, _ = cols["_mask"].shape
    st = stack_init(gla, _batch(P, lanes), cols["_mask"].device)
    views = [fold_merge(gla.merge, st, lanes, dim=1) if lanes > 1 else st]
    for c in range(C):
        st, view = accumulate_chunk(gla, st, {k: v[:, c] for k, v in cols.items()},
                                    lanes)
        views.append(view)
    return views[-1], tree_stack(views, dim=1)


def scan_round_step(gla: GLA, states: Pytree, round_cols: dict, lanes: int):
    """Advance laned per-partition states by ONE round-slice of chunks.

    Returns (new laned states, lane-merged round-boundary view)."""
    for c in range(round_cols["_mask"].shape[1]):
        states, _ = accumulate_chunk(
            gla, states, {k: v[:, c] for k, v in round_cols.items()}, lanes)
    view = fold_merge(gla.merge, states, lanes, dim=1) if lanes > 1 else states
    return states, view


def _round_slices(cols: dict, rounds: int, what: str):
    C = cols["_mask"].shape[1]
    if C % rounds:
        raise ValueError(f"{what} needs C % rounds == 0, got {C} % {rounds}")
    per = C // rounds
    for r in range(rounds):
        yield {k: v[:, r * per:(r + 1) * per] for k, v in cols.items()}


def scan_rounds(gla: GLA, cols: dict, lanes: int, rounds: int):
    """Uniform-schedule path: states only at round boundaries.

    Returns ``(final view [P, ...], views [P, R, ...])``."""
    P = cols["_mask"].shape[0]
    st = stack_init(gla, _batch(P, lanes), cols["_mask"].device)
    views = []
    for sl in _round_slices(cols, rounds, "the uniform rounds path"):
        st, view = scan_round_step(gla, st, sl, lanes)
        views.append(view)
    final = fold_merge(gla.merge, st, lanes, dim=1) if lanes > 1 else st
    return final, tree_stack(views, dim=1)


# ---------------------------------------------------------------------------
# fused-kernel paths (repro_torch/kernels/fused_agg.py)
# ---------------------------------------------------------------------------

def fused_available(gla: GLA) -> bool:
    """True when ``gla`` publishes the fused kernel contract."""
    return fused_agg.fused_available(gla)


def fused_round_step(gla: GLA, state, slice_cols: dict):
    """K1 for ONE round-slice of every partition: (state, slice) -> state.

    Carry-style: the incoming state rides into the kernel and every chunk
    accumulates on top, so starting from ``gla.init`` keeps the
    chunk-sequential association from round 0."""
    return fused_agg.fused_round_step(gla, state, slice_cols)


def fused_rounds_states(gla: GLA, cols: dict, rounds: int):
    """One K1 launch per round-slice with the carry threaded through.

    Returns ``(final [P, ...], views [P, R, ...])``.  Requires C % rounds == 0.
    """
    P = cols["_mask"].shape[0]
    st = stack_init(gla, (P,), cols["_mask"].device)
    views = []
    for sl in _round_slices(cols, rounds, "the fused kernel path"):
        st = fused_round_step(gla, st, sl)
        views.append(st)
    return st, tree_stack(views, dim=1)


def fused_prefix_states(gla: GLA, cols: dict):
    """K2: one launch for the whole data, emitting per-chunk prefixes.
    Returns ``(final [P, ...], prefixes [P, C+1, ...])``."""
    return fused_agg.fused_prefix_states(gla, cols)


# ---------------------------------------------------------------------------
# liveness accounting (node failure, paper §4.6)
# ---------------------------------------------------------------------------

def round_weights(alive, rounds: int, device=None):
    """Normalize an alive mask to ([P, R] merge weights, [P] final weights).

    ``alive`` is [P] (partition dead for the whole query) or [R, P] (row r
    gives liveness during round r).  The final result merges with the last
    round's liveness."""
    alive = torch.as_tensor(alive, device=device)
    if alive.ndim == 1:
        a = alive.to(torch.float32)
        return a[:, None].expand(alive.shape[0], rounds), a
    w = alive.T.to(torch.float32)  # [P, R]
    return w, w[:, -1]
