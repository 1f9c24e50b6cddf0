"""Shared scan/merge core — port of ``repro/core/scan.py:70-461,483-632``.

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
  ``scan_rounds_masked``   state only at round boundaries, any schedule
                           (per-partition windows, liveness-masked).
  ``fused_rounds_states``  one K1 launch per round-slice (all partitions);
                           group and bundle states on ``emit="kernel"``.
  ``fused_prefix_states``  one K2 launch for the whole data; scalar states
                           on ``emit="kernel"``.

and, where the fused contract cannot be used (no ``gla.fused``, or a join
over the reference's probe budget), the legacy ``kernel_cols`` paths:

  ``kernel_prefix_states``        one K4 launch for the whole data; scalar.
  ``kernel_rounds_states``        one K3 launch per round-slice; group-by.
  ``bundle_kernel_rounds_states`` one K3 launch per round-slice for every
                                  member of a bundle.

The reference launches its kernels once per partition; here the partition
axis stays a batch axis and one launch covers all P partitions.
``scan_round_step``, ``fused_round_step`` and :data:`ROUND_DELTA_FNS` are
also the session's per-round-slice primitives (:func:`round_step`, which
``repro_torch.session`` and ``repro_torch.sharded`` call).
:func:`merge_carries` and :func:`split_carries` carry a paused session's
states to another partition count (elastic resume).
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import estimators as E
from repro_torch import obs
from repro_torch.data import encodings as ENC
from repro_torch.kernels import fused_agg, ops
from repro_torch.uda import GLA, tree_map, tree_stack

Pytree = Any

#: chunks folded by :func:`accumulate_chunk` (every partition's chunk c in
#: one call) in this process: what the audit's ``one_chunk_pass`` reads
#: around a dry step (``repro_torch.audit``)
CHUNK_STEPS = 0


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
    [P, lanes, ...] and each lane takes a contiguous L/lanes of the rows.
    Adds one to :data:`CHUNK_STEPS`."""
    global CHUNK_STEPS
    CHUNK_STEPS += 1
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

def scan_prefix(gla: GLA, cols: dict, lanes: int, on_chunk=None):
    """Scan chunks emitting every prefix state (init prepended).

    ``on_chunk``, when given, is called after every chunk: the per-chunk
    coordination of the sharded sync barrier (``repro_torch.sharded``).
    Returns ``(final view [P, ...], prefixes [P, C+1, ...])``."""
    P, C, _ = cols["_mask"].shape
    st = stack_init(gla, _batch(P, lanes), cols["_mask"].device)
    views = [fold_merge(gla.merge, st, lanes, dim=1) if lanes > 1 else st]
    for c in range(C):
        st, view = accumulate_chunk(gla, st, {k: v[:, c] for k, v in cols.items()},
                                    lanes)
        views.append(view)
        if on_chunk is not None:
            on_chunk()
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


def scan_rounds_masked(gla: GLA, cols: dict, sched, lanes: int):
    """Any-schedule path for large states: state only at round boundaries.

    ``sched`` is the cumulative [P, R+1] chunk schedule.  Round r takes, in
    chunk order, every chunk that lies in some partition's window
    [sched[p, r], sched[p, r+1]) with each partition's ``_mask`` multiplied
    by its own liveness (lo <= c < hi), as the reference's masked scan.
    The reference also folds the chunks that lie in no partition's window,
    fully masked; a fully masked chunk adds exact zeros to every state of
    the port's GLAs (finite columns), so they are skipped here.  Returns
    ``(final view [P, ...], views [P, R, ...])``."""
    mask = cols["_mask"]
    P = mask.shape[0]
    sched = np.asarray(sched, np.int64)
    st = stack_init(gla, _batch(P, lanes), mask.device)
    views = []
    for r in range(sched.shape[1] - 1):
        lo, hi = sched[:, r], sched[:, r + 1]
        chunks = np.unique(np.concatenate(
            [np.arange(a, b) for a, b in zip(lo, hi)] + [np.zeros(0, np.int64)]))
        # [chunks, P] liveness, moved to the device once per round
        live = torch.from_numpy((chunks[:, None] >= lo) & (chunks[:, None] < hi)).to(
            mask.device, mask.dtype)
        for i, c in enumerate(chunks.tolist()):
            chunk = {k: v[:, c] for k, v in cols.items()}
            chunk["_mask"] = chunk["_mask"] * live[i][:, None]
            st, _ = accumulate_chunk(gla, st, chunk, lanes)
        views.append(fold_merge(gla.merge, st, lanes, dim=1) if lanes > 1 else st)
    final = fold_merge(gla.merge, st, lanes, dim=1) if lanes > 1 else st
    return final, tree_stack(views, dim=1)


# ---------------------------------------------------------------------------
# elastic carry algebra (resume on another partition count)
# ---------------------------------------------------------------------------

def merge_carries(states: Pytree, group: int) -> Pytree:
    """Fold a [P, ...] carry to [P/group, ...] partitions.

    New partition i is the left fold (old partition i·group first, each
    next one added onto it) of old partitions [i·group, (i+1)·group), the
    association of :func:`fold_merge`.  Valid for additive merges only, the
    contract the engine's weighted liveness merges already require."""
    def m(x):
        if x.shape[0] % group:
            raise ValueError(f"cannot merge {x.shape[0]} partitions in groups of {group}")
        g = x.reshape(x.shape[0] // group, group, *x.shape[1:])
        acc = g[:, 0]
        for j in range(1, group):
            acc = acc + g[:, j]
        return acc

    return tree_map(m, states)


def split_carries(states: Pytree, group: int) -> Pytree:
    """Expand a [P, ...] carry to [P·group, ...] partitions.

    Child p·group inherits parent p's whole carry; the other children start
    from the additive identity (zeros).  To an additive merge where a carry
    lives is unobservable, so merged snapshots, finals and estimates are
    kept; ``merge_carries(split_carries(x, k), k)`` is ``x`` (x + 0)."""
    def s(x):
        z = torch.zeros_like(x)
        return torch.stack([x, *[z] * (group - 1)], dim=1).reshape(
            x.shape[0] * group, *x.shape[1:])

    return tree_map(s, states)


# ---------------------------------------------------------------------------
# fused-kernel paths (repro_torch/kernels/fused_agg.py)
# ---------------------------------------------------------------------------

def fused_available(gla: GLA, columns=None) -> bool:
    """True when ``gla`` (and every bundle member) publishes the fused
    kernel contract, every source column (``columns``: the source's
    ``ColumnSpec`` table) is kernel-decodable — no trailing dims — and its
    probe tables fit the reference's budget."""
    return fused_agg.fused_available(gla, columns)


def fused_round_step(gla: GLA, state, slice_cols: dict, encodings=()):
    """K1 for ONE round-slice of every partition: (state, slice) -> state.

    Carry-style: the incoming state rides into the kernel and every chunk
    accumulates on top, so starting from ``gla.init`` keeps the
    chunk-sequential association from round 0.  ``encodings`` is the
    source's (name, Encoding) tuple: those columns arrive physical and are
    decoded first, in one launch."""
    return fused_agg.fused_round_step(gla, state, slice_cols, encodings)


def fused_rounds_states(gla: GLA, cols: dict, rounds: int, encodings=()):
    """One K1 launch per round-slice with the carry threaded through (a
    bundle: one launch for every member).

    Returns ``(final [P, ...], views [P, R, ...])``.  Requires C % rounds == 0.
    """
    P = cols["_mask"].shape[0]
    st = stack_init(gla, (P,), cols["_mask"].device)
    views = []
    for r, sl in enumerate(_round_slices(cols, rounds, "the fused kernel path")):
        with obs.span("pfola.round", r=r):
            st = fused_round_step(gla, st, sl, encodings)
        views.append(st)
    return st, tree_stack(views, dim=1)


def fused_prefix_states(gla: GLA, cols: dict, encodings=()):
    """K2: one launch for the whole data, emitting per-chunk prefixes.
    Returns ``(final [P, ...], prefixes [P, C+1, ...])``."""
    return fused_agg.fused_prefix_states(gla, cols, encodings)


# ---------------------------------------------------------------------------
# legacy kernel_cols paths (kernels/ops.py: K3, K4)
# ---------------------------------------------------------------------------

def _live(mask: torch.Tensor) -> torch.Tensor:
    """Live rows per partition, f32 [P] — exact integers: the per-chunk
    counts (``fused_agg._live_counts``) summed in f64."""
    return fused_agg._live_counts(mask).sum(dim=1).to(torch.float32)


def _scalar_projection(gla: GLA, cols: dict):
    assert gla.kernel_cols is not None, "GLA does not publish kernel_cols"
    mask = cols["_mask"]
    vals, weight = gla.kernel_cols(cols)
    return vals.reshape(mask.shape), weight.reshape(mask.shape), mask


def kernel_prefix_states(gla: GLA, cols: dict):
    """One K4 launch for the whole ``[P, C, L]`` data -> SumState prefixes.

    K4 emits per-chunk (sum, sumsq, scanned, matched) partials; additivity
    turns the prefix states into their cumsum over chunks, taken outside
    the kernel as in the reference.  Interchangeable (not bitwise) with
    :func:`scan_prefix`.  Returns ``(final [P, ...], prefixes [P, C+1, ...])``.
    """
    partials = ops.shard_chunk_partials(*_scalar_projection(gla, cols))
    P = partials.shape[0]
    cum = torch.cat([torch.zeros((P, 1, 4), dtype=partials.dtype,
                                 device=partials.device),
                     partials.cumsum(dim=1)], dim=1)  # [P, C+1, 4]
    prefixes = E.SumState(sum=cum[..., 0:1], sumsq=cum[..., 1:2],
                          scanned=cum[..., 2], matched=cum[..., 3])
    return tree_map(lambda x: x[:, -1], prefixes), prefixes


def kernel_scalar_round_delta(gla: GLA, slice_cols: dict):
    """Scalar SumState delta of ONE round-slice: one K4 launch, the slice's
    chunk partials summed in chunk order (the last row of their cumsum).
    Adding deltas round by round re-associates against the whole-shard
    cumsum of :func:`kernel_prefix_states`: interchangeable, not bitwise."""
    tot = ops.shard_chunk_partials(*_scalar_projection(gla, slice_cols))
    tot = tot.cumsum(dim=1)[:, -1]  # [P, 4]
    return E.SumState(sum=tot[:, 0:1], sumsq=tot[:, 1:2], scanned=tot[:, 2],
                      matched=tot[:, 3])


def _fold_running_sum(deltas):
    """Fold per-round additive deltas into round-boundary states.

    Sequential adds on purpose: the whole-scan loop and the session's
    round-by-round steps fold the same deltas in the same order, so their
    states are bitwise-equal.  Returns (final, views stacked [P, R, ...]).
    """
    acc, views = deltas[0], [deltas[0]]
    for d in deltas[1:]:
        acc = tree_map(torch.add, acc, d)
        views.append(acc)
    return acc, tree_stack(views, dim=1)


def _group_agg(vals, w, gids, num_groups: int, L: int):
    """K3 over flat per-partition rows: vals [P, N, A], w/gids [P, N]."""
    return ops.group_agg(vals.to(torch.float32).contiguous(),
                         w.to(torch.float32).contiguous(),
                         gids.to(torch.int32).contiguous(),
                         num_groups=num_groups, block_rows=L)


def kernel_round_delta(gla: GLA, slice_cols: dict):
    """Group-by SumState delta of ONE round-slice: one K3 launch with
    ``block_rows`` = L, so the kernel keeps the chunk-by-chunk association.
    The primitive of both :func:`kernel_rounds_states` and the session's
    ``kernel_group`` steps."""
    assert gla.kernel_cols is not None, "GLA does not publish kernel_cols"
    assert gla.kernel_num_groups is not None, (
        "GLA publishes the scalar kernel contract, not the group-by one")
    mask = slice_cols["_mask"]
    P, per, L = mask.shape
    vals, weight, gids = gla.kernel_cols(slice_cols)
    if vals.ndim == mask.ndim:
        vals = vals.unsqueeze(-1)
    sums, sumsqs, matched = _group_agg(
        vals.reshape(P, per * L, vals.shape[-1]),
        (weight * mask).reshape(P, per * L), gids.reshape(P, per * L),
        gla.kernel_num_groups, L)
    return E.SumState(sum=sums, sumsq=sumsqs, scanned=_live(mask),
                      matched=matched)


def kernel_rounds_states(gla: GLA, cols: dict, rounds: int):
    """One K3 launch per round-slice -> group SumState views.

    The dense [G, A] state makes per-chunk prefixes infeasible, so this
    path emits at round boundaries: the round states are the running sum of
    the per-round deltas (:func:`_fold_running_sum`).  Returns
    ``(final [P, ...], views [P, R, ...])``; requires C % rounds == 0."""
    return _fold_running_sum([
        kernel_round_delta(gla, sl)
        for sl in _round_slices(cols, rounds, "the group-by kernel path")])


def _bundle_member_projection(member: GLA, sl: dict):
    """A member's kernel projection as (vals [P, C, L, A], w, gids, G).

    A scalar member becomes a one-group table (every row in group 0), so
    one K3 launch serves scalar and group-by members alike."""
    assert member.kernel_cols is not None, (
        f"bundle member {member.name!r} does not publish kernel_cols")
    mask = sl["_mask"]
    if member.kernel_num_groups is None:
        vals, weight = member.kernel_cols(sl)
        gids, G = torch.zeros(mask.shape, dtype=torch.int32,
                              device=mask.device), 1
    else:
        vals, weight, gids = member.kernel_cols(sl)
        G = member.kernel_num_groups
    if vals.ndim == mask.ndim:
        vals = vals.unsqueeze(-1)
    return vals, weight * mask, gids.to(torch.int32), G


def bundle_operands(gla: GLA, slice_cols: dict):
    """K3's operands for ONE round-slice of a bundle: every member's
    projection stacked row-wise per partition (vals [P, M·N, A_max] zero-
    padded to the widest member, w and gids [P, M·N], member m's ids
    offset by ``offsets[m]`` into one table of ``num_groups`` rows), plus
    each member's aggregate count.  Returns ``(vals, w, gids, num_groups,
    offsets, aggs)``."""
    members = gla.members
    assert members, "bundle kernel path needs a GLABundle"
    P, per, L = slice_cols["_mask"].shape
    N = per * L
    projs = [_bundle_member_projection(m, slice_cols) for m in members]
    A_max = max(v.shape[-1] for v, _, _, _ in projs)
    vals_cat, w_cat, gids_cat, offs = [], [], [], []
    off = 0
    for vals, w, gids, G in projs:
        offs.append(off)
        pad = A_max - vals.shape[-1]
        vals = vals.to(torch.float32)
        if pad:
            vals = torch.cat([vals, vals.new_zeros((*vals.shape[:-1], pad))], -1)
        vals_cat.append(vals.reshape(P, N, A_max))
        w_cat.append(w.reshape(P, N))
        gids_cat.append((gids + off).reshape(P, N))
        off += G
    return (torch.cat(vals_cat, 1), torch.cat(w_cat, 1), torch.cat(gids_cat, 1),
            off, offs, [v.shape[-1] for v, _, _, _ in projs])


def bundle_round_deltas(gla: GLA, slice_cols: dict):
    """Per-member SumState deltas of ONE round-slice of a bundle, in ONE K3
    launch over :func:`bundle_operands`.  Each member's rows are whole
    chunks of L rows, so a member's table rows take adds from its own rows
    only: group-by members are bitwise-equal to their solo K3 launch;
    scalar members, one-group tables here, are interchangeable with their
    solo K4 path.  Returns one delta per member."""
    mask = slice_cols["_mask"]
    vals, w, gids, num_groups, offs, aggs = bundle_operands(gla, slice_cols)
    sums, sumsqs, matched = _group_agg(vals, w, gids, num_groups, mask.shape[2])
    scanned = _live(mask)
    deltas = []
    for m, o, A in zip(gla.members, offs, aggs):
        G = m.kernel_num_groups
        if G is None:
            deltas.append(E.SumState(sum=sums[:, o, :1], sumsq=sumsqs[:, o, :1],
                                     scanned=scanned, matched=matched[:, o]))
        else:
            deltas.append(E.SumState(
                sum=sums[:, o:o + G, :A], sumsq=sumsqs[:, o:o + G, :A],
                scanned=scanned, matched=matched[:, o:o + G]))
    return tuple(deltas)


def bundle_kernel_rounds_states(gla: GLA, cols: dict, rounds: int):
    """ONE K3 launch per round-slice for a whole bundle
    (:func:`bundle_round_deltas`), each member's deltas folded into its
    round states.  Returns ``(tuple of member finals, tuple of member
    views [P, R, ...])``; requires C % rounds == 0."""
    per_round = [bundle_round_deltas(gla, sl)
                 for sl in _round_slices(cols, rounds, "the bundle kernel path")]
    folded = [_fold_running_sum(list(ds)) for ds in zip(*per_round)]
    return tuple(f for f, _ in folded), tuple(v for _, v in folded)


#: The session's path name -> per-round-slice delta primitive.  Delta-style:
#: the first round's state IS its delta, later rounds add onto it.  The
#: carry-style "kernel_fused" path calls :func:`fused_round_step` instead.
ROUND_DELTA_FNS = {
    "kernel_scalar": kernel_scalar_round_delta,
    "kernel_group": kernel_round_delta,
    "kernel_bundle": bundle_round_deltas,
}


def round_step(gla: GLA, states: Pytree, slice_cols: dict, *, path: str,
               lanes: int, first: bool, encodings=()):
    """Advance per-partition states by ONE round-slice on a session path:
    ``"scan"`` (:func:`scan_round_step`), the carry-style ``"kernel_fused"``
    (one K1 launch for every partition) or a delta-style legacy path of
    :data:`ROUND_DELTA_FNS`, where ``first`` starts the running sum from
    the first delta (not zero + delta), as :func:`_fold_running_sum` does.
    ``encodings`` is the source's (name, Encoding) tuple: the fused step
    decodes its physical columns, every other path decodes the slice
    first (one decode launch either way).  Returns (new states, round
    views)."""
    if encodings and path != "kernel_fused":
        slice_cols = ENC.decode_cols(slice_cols, encodings)
    if path == "scan":
        return scan_round_step(gla, states, slice_cols, lanes)
    if path == "kernel_fused":
        new = fused_round_step(gla, states, slice_cols, encodings)
        return new, new
    delta = ROUND_DELTA_FNS[path](gla, slice_cols)
    new = delta if first else tree_map(torch.add, states, delta)
    return new, new


# ---------------------------------------------------------------------------
# liveness accounting (node failure, paper §4.6)
# ---------------------------------------------------------------------------

def round_weights(alive, rounds: int, device=None):
    """Normalize an alive mask to ([P, R] merge weights, [P] final weights).

    ``alive`` is [P] (partition dead for the whole query) or [R, P] (row r
    gives liveness during round r).  The final result merges with the last
    round's liveness."""
    with obs.span("pfola.sync.weights"):  # from the host: waits for the stream
        alive = torch.as_tensor(alive, device=device)
    if alive.ndim == 1:
        a = alive.to(torch.float32)
        return a[:, None].expand(alive.shape[0], rounds), a
    w = alive.T.to(torch.float32)  # [P, R]
    return w, w[:, -1]
