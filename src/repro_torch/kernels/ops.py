"""The ``kernel_cols`` and chunk-aggregate kernels on Hopper — port of
``repro/kernels/ops.py:46-149``.

  K3 :func:`group_agg_bundle`      per-group sums of a round-slice's rows
                                   for every member of a bundle in one
                                   launch, each at its own shape
                                   (``csrc/group_agg.cu``,
                                   ``pf_group_agg_bundle``).  Serves
                                   ``scan.bundle_round_deltas``.
     :func:`group_agg`             the same launch with one member.
                                   Serves ``scan.kernel_round_delta``:
                                   group-by GLAs whose fused contract
                                   cannot be used (a join over the probe
                                   budget, ``fused=None``).
  K4 :func:`shard_chunk_partials`  per-chunk (Σv·wm, Σv²·wm, Σm, Σwm) of a
                                   whole shard (``csrc/chunk_agg.cu``,
                                   ``pf_shard_partials``).  Serves
                                   ``scan.kernel_prefix_states`` and
                                   ``scan.kernel_scalar_round_delta``.
  K5 :func:`chunk_agg`             the same four sums over one flat chunk
                                   (``pf_chunk_agg``, beside K4).
  K6 :func:`q6_agg`                all of TPC-H Q6 from its raw columns, the
                                   predicate evaluated in the kernel
                                   (``pf_q6_agg``).  No entry point of
                                   either package reaches K5 or K6: only
                                   the tests and ``chip_smoke.py`` call them.

The reference pads G to 128 and A to 8 for the TPU's matrix unit and
launches once per partition; here the shapes stay as they are and one
call covers every partition.  K3 runs the group step of K1
(``csrc/agg_common.cuh``): per-chunk partials into a scratch table, then
an ordered fold, in tiles of chunks sized by :func:`group_step_tile`; one
call counts as one launch however many tiles and grids it takes.  On CPU
tensors the wrappers run the plain versions in ``kernels/ref.py`` (counted
in ``DISPATCHES`` only); on CUDA tensors they launch the kernel or raise
(``kernels/_runtime.py``).
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import _build, ref
from repro_torch.kernels import _runtime as RT


def _group_lib():
    return RT.bind(_build.load("group_agg"), pf_group_agg_bundle=(1, 5))


#: members in one ``pf_group_agg_bundle`` launch (``csrc/agg_common.cuh``
#: ``kMaxMembers``)
MAX_BUNDLE_MEMBERS = 16
_BUNDLE_COLS = 10  # int64 slots of a member's row (``csrc/group_agg.cu``)


#: the most carry floats of one window of the group step's fold (32·s ids,
#: 2A+1 columns) where a lane owns more than one id (``csrc/agg_common.cuh``
#: ``kFoldSpanFloats``): 12 KB, so that two blocks of 8 warps, each holding
#: a window's columns in shared memory, fit an SM
FOLD_SPAN_FLOATS = 3072


#: where phase 1 of the group step drops zero-weight rows (s > 1), the kept
#: rows of a chunk up to which it sorts them by counting each row's place
#: rather than by radix passes (``csrc/agg_common.cuh`` ``kRankSortRows``);
#: both give the same order
RANK_SORT_ROWS = 384


def group_step_span(L: int, A: int, G: int) -> int:
    """Ids a lane of the group step's fold owns, so that a window spans
    ``32·s`` ids (``csrc/agg_common.cuh`` ``step_span``): the largest power
    of two ``<= G / 4L`` (1 where ``G < 8L``), so that a window takes at
    most 8 of a chunk's ``L`` rows on average, whose window of ``2A+1``
    floats an id fits :data:`FOLD_SPAN_FLOATS`.  The same rule picks the
    members whose phase 1 drops, before its sort, the rows that cannot
    change a sum (weight 0, every value finite): those with ``s > 1``."""
    s = 1
    while 8 * s * L <= G and 64 * s * (2 * A + 1) <= FOLD_SPAN_FLOATS:
        s *= 2
    return s


def group_step_words(L: int, A: int, G: int) -> int:
    """Scratch floats of one chunk's table in the group step: an offset per
    window of ``32·s`` ids (:func:`group_step_span`) and one more, then
    ``min(L, G)`` ids and ``(2A+1)·min(L, G)`` sums.  The wrappers pass it
    to the kernel as the tables' stride, and the kernel refuses one below
    its own layout's size (``csrc/agg_common.cuh`` ``group_step_words``)
    before either phase."""
    return -(-G // (32 * group_step_span(L, A, G))) + 1 + min(L, G) * (2 * A + 2)


def group_step_visits(P: int, C: int, L: int, members) -> int:
    """The (partition, window, chunk) triples the fold of a launch over
    ``P`` partitions of ``C`` chunks of ``L`` rows visits, summed over the
    group ``members`` ((A, G) each): ``P · ceil(G / 32s) · C`` a member
    (:func:`group_step_span`), however the chunks fall into tiles."""
    return sum(P * -(-G // (32 * group_step_span(L, A, G))) * C for A, G in members)


def group_step_tile(C: int, L: int, members) -> int:
    """Chunks per tile of the group step over ``C`` chunks of ``L`` rows for
    ``members`` ((A, G) each): as many as keep the scratch
    (:func:`group_step_words` per chunk and member) within the members' own
    input bytes (vals, w and gids: ``L·(4A + 8)`` per chunk), at least 1 and
    at most ``C`` (1 when there is no member)."""
    inp = sum(L * (4 * A + 8) for A, _ in members)
    scratch = sum(4 * group_step_words(L, A, G) for A, G in members)
    return max(1, min(C, C * inp // scratch)) if members else 1


def group_step_scratch(P: int, C: int, L: int, A: int, G: int, tile: int,
                       device) -> torch.Tensor:
    """One member's group-step scratch for tiles of ``tile`` chunks."""
    n = P * min(tile, C) * group_step_words(L, A, G)
    return torch.empty(n, dtype=RT.F32, device=device)


def _chunk_lib():
    return RT.bind(_build.load("chunk_agg"), pf_shard_partials=(4, 3),
                   pf_chunk_agg=(5, 1), pf_q6_agg=(8, 1))


#: block totals K5 and K6 fold (csrc/chunk_agg.cu kFlatBlocks)
_FLAT_BLOCKS = 1024


def _check_group_agg(vals, weight, gids, num_groups, block_rows, what):
    """K3's input checks; returns ``vals`` as ``[P, N, A]``."""
    if isinstance(vals, torch.Tensor) and vals.ndim == 2:
        vals = vals.unsqueeze(-1)
    if not isinstance(vals, torch.Tensor) or vals.ndim != 3:
        raise ValueError(f"{what}: vals must be a [P, N] or [P, N, A] tensor")
    P, N, A = vals.shape
    dev = vals.device
    RT.check("vals", vals, RT.F32, (P, N, A), dev)
    RT.check("weight", weight, RT.F32, (P, N), dev)
    RT.check("gids", gids, RT.I32, (P, N), dev)
    if min(P, A, num_groups, block_rows) < 1 or N % block_rows:
        raise ValueError(f"{what} needs P, A, G, block_rows >= 1 and N % "
                         f"block_rows == 0, got N={N}, block_rows={block_rows}")
    if RT.route(dev) == "cuda" and block_rows > RT.MAX_GROUP_ROWS:
        raise ValueError(f"{what} sorts a block in shared memory: "
                         f"block_rows={block_rows} exceeds {RT.MAX_GROUP_ROWS}")
    return vals


def _outputs(P: int, G: int, A: int, dev):
    sums = torch.empty((P, G, A), dtype=RT.F32, device=dev)
    return sums, torch.empty_like(sums), torch.empty((P, G), dtype=RT.F32, device=dev)


def group_agg(vals: torch.Tensor, weight: torch.Tensor, gids: torch.Tensor, *,
              num_groups: int, block_rows: int):
    """K3: ``vals [P, N]`` or ``[P, N, A]`` f32, ``weight [P, N]`` f32
    (predicate · ``_mask``), ``gids [P, N]`` i32 -> ``(sums [P, G, A],
    sumsqs [P, G, A], matched [P, G])`` from zero.  Ids outside [0, G) drop
    out.  ``N`` must be a multiple of ``block_rows``: each block of rows is
    summed per group from zero and added to the totals in block order, so
    with ``block_rows`` = the chunk length the totals keep the chunk-by-chunk
    association of the scan."""
    vals = _check_group_agg(vals, weight, gids, num_groups, block_rows, "group_agg")
    P, N, A = vals.shape
    dev = vals.device
    C = N // block_rows
    count_fold_visits(P, C, block_rows, [(A, num_groups)])
    if RT.route(dev) == "plain":
        RT.plain("group_agg")
        return ref.group_agg(vals, weight, gids, num_groups, block_rows)
    return _group_bundle_launch([vals], [(vals, weight, gids, num_groups)],
                                [(A, num_groups)], P, N, block_rows, dev)[0]


def group_agg_bundle(members, *, block_rows: int):
    """K3 for every member of a bundle over the same rows: ``members`` holds
    ``(vals, weight, gids, num_groups)`` a member, each as :func:`group_agg`
    takes it, all with the same ``[P, N]``.  ONE launch
    (``pf_group_agg_bundle``) of up to :data:`MAX_BUNDLE_MEMBERS` members (a
    larger bundle takes one launch per that many), each member at its own
    (A, G): its own fold windows and scratch, no padding to the widest
    member and no offset ids.  A member's arithmetic is that of its solo
    launch, so each member's result is bitwise its :func:`group_agg`.
    Returns ``(sums, sumsqs, matched)`` a member, in order."""
    if not members:
        raise ValueError("a group_agg bundle needs one or more members, got none")
    vals = [_check_group_agg(v, w, g, G, block_rows, "group_agg_bundle")
            for v, w, g, G in members]
    P, N, _ = vals[0].shape
    dev = vals[0].device
    for v in vals:
        if v.shape[:2] != (P, N) or v.device != dev:
            raise ValueError("group_agg_bundle members need the same [P, N] rows "
                             "on one device")
    shapes = [(v.shape[2], m[3]) for v, m in zip(vals, members)]
    C = N // block_rows
    count_fold_visits(P, C, block_rows, shapes)
    launches = -(-len(members) // MAX_BUNDLE_MEMBERS)
    if RT.route(dev) == "plain":
        RT.plain("group_agg", launches)
        return [ref.group_agg(v, m[1], m[2], m[3], block_rows)
                for v, m in zip(vals, members)]
    outs = []
    for i in range(0, len(members), MAX_BUNDLE_MEMBERS):
        part = slice(i, i + MAX_BUNDLE_MEMBERS)
        outs += _group_bundle_launch(vals[part], members[part], shapes[part], P, N,
                                     block_rows, dev)
    return outs


def _group_bundle_launch(vals, members, shapes, P: int, N: int, L: int, dev):
    """One ``pf_group_agg_bundle`` launch over at most MAX_BUNDLE_MEMBERS
    members."""
    C = N // L
    tile = group_step_tile(C, L, shapes)
    table = torch.zeros((len(members), _BUNDLE_COLS), dtype=torch.int64)
    outs, keep = [], []  # keep: the scratch, whose address alone the table holds
    for i, (v, (_, w, g, _), (A, G)) in enumerate(zip(vals, members, shapes)):
        out = _outputs(P, G, A, dev)
        scratch = group_step_scratch(P, C, L, A, G, tile, dev)
        table[i] = torch.tensor([A, G] + [t.data_ptr() for t in (v, w, g, *out, scratch)]
                                + [group_step_words(L, A, G)])
        outs.append(out)
        keep.append(scratch)
    lib = _group_lib()
    RT.launch(lib, lib.pf_group_agg_bundle, RT.ptr(table), len(members), P, N, L,
              tile, device=dev, count="group_agg")
    count_wide_folds(shapes, L)
    return outs


def count_wide_folds(members, L: int) -> None:
    """Add the group members ((A, G) each) of a launch over chunks of ``L``
    rows whose fold takes more than one id a lane to the ``pfola.fold.wide``
    counter (recorded only while ``obs`` records).  They are also exactly
    the members whose phase 1 drops the zero-weight rows before its sort
    (:func:`group_step_span`)."""
    if not obs.on():
        return
    n = sum(group_step_span(L, A, G) > 1 for A, G in members)
    if n:
        obs.count("pfola.fold.wide", n)


def count_fold_visits(P: int, C: int, L: int, members) -> None:
    """Add the (partition, window, chunk) triples a launch's fold visits
    (:func:`group_step_visits` of its group ``members``, from the shapes
    alone: no sync) to the ``pfola.fold.visits`` counter, on either route
    (recorded only while ``obs`` records)."""
    if members and obs.on():
        obs.count("pfola.fold.visits", group_step_visits(P, C, L, members))


def shard_chunk_partials(vals: torch.Tensor, weight: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """K4: ``vals``, ``weight`` (the bare predicate), ``mask`` ``[P, C, L]``
    of any numeric dtype (cast to f32 here) -> ``[P, C, 4]`` f32 per chunk:
    (Σv·wm, Σ(v·v)·wm, Σm, Σwm) with ``wm = weight·mask``."""
    if not isinstance(mask, torch.Tensor) or mask.ndim != 3:
        raise ValueError("mask must be a [P, C, L] tensor")
    dev = mask.device
    v, w, m = (x.to(RT.F32).contiguous() if isinstance(x, torch.Tensor) else x
               for x in (vals, weight, mask))
    for name, t in (("vals", v), ("weight", w), ("mask", m)):
        RT.check(name, t, RT.F32, mask.shape, dev)
    if RT.route(dev) == "plain":
        RT.plain("shard_chunk_partials")
        return ref.shard_chunk_partials(v, w, m)
    P, C, L = mask.shape
    out = torch.empty((P, C, 4), dtype=RT.F32, device=dev)
    lib = _chunk_lib()
    RT.launch(lib, lib.pf_shard_partials, RT.ptr(v), RT.ptr(w), RT.ptr(m),
              RT.ptr(out), P, C, L, device=dev, count="shard_chunk_partials")
    return out


def _flat(name, t, dev):
    if not isinstance(t, torch.Tensor) or t.ndim != 1:
        raise ValueError(f"{name} must be a flat [N] tensor")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")


def chunk_agg(vals: torch.Tensor, weight: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """K5: flat ``[N]`` ``vals``, ``weight`` (the predicate), ``mask`` of
    any numeric dtype -> ``[4]`` f32 (Σv·wm, Σ(v·v)·wm, Σm, Σwm) with
    ``wm = weight·mask``.  Inputs that are not f32 are cast first."""
    if not isinstance(mask, torch.Tensor):
        raise ValueError("mask must be a flat [N] tensor")
    dev = mask.device
    for name, t in (("vals", vals), ("weight", weight), ("mask", mask)):
        _flat(name, t, dev)
    v, w, m = (x.to(RT.F32).contiguous() for x in (vals, weight, mask))
    for name, t in (("vals", v), ("weight", w), ("mask", m)):
        RT.check(name, t, RT.F32, mask.shape, dev)
    if RT.route(dev) == "plain":
        RT.plain("chunk_agg")
        return ref.chunk_agg(v, w, m)
    _check_rows(m.numel())
    part = torch.empty(4 * _FLAT_BLOCKS, dtype=RT.F32, device=dev)
    out = torch.empty(4, dtype=RT.F32, device=dev)
    lib = _chunk_lib()
    RT.launch(lib, lib.pf_chunk_agg, RT.ptr(v), RT.ptr(w), RT.ptr(m),
              RT.ptr(part), RT.ptr(out), m.numel(), device=dev, count="chunk_agg")
    return out


def q6_agg(params: torch.Tensor, shipdate: torch.Tensor, discount: torch.Tensor,
           quantity: torch.Tensor, extendedprice: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """K6: Q6 from raw flat ``[N]`` columns — shipdate int32, discount,
    quantity, extendedprice and mask f32, as stored (no column is cast or
    copied before the kernel) — with ``params`` f32 ``[>= 5]`` (date_lo,
    date_hi, disc_lo, disc_hi, qty_eq) -> ``[4]`` f32 as :func:`chunk_agg`
    of value ``ep·dc`` and weight ``cond·mask``."""
    if not isinstance(mask, torch.Tensor):
        raise ValueError("mask must be a flat [N] tensor")
    dev = mask.device
    RT.check("shipdate", shipdate, RT.I32, mask.shape, dev)
    for name, t in (("discount", discount), ("quantity", quantity),
                    ("extendedprice", extendedprice), ("mask", mask)):
        _flat(name, t, dev)
        RT.check(name, t, RT.F32, mask.shape, dev)
    if not isinstance(params, torch.Tensor) or params.ndim != 1 or params.numel() < 5:
        raise ValueError("params must be a [>= 5] tensor (date_lo, date_hi, "
                         "disc_lo, disc_hi, qty_eq)")
    RT.check("params", params, RT.F32, params.shape, dev)
    if RT.route(dev) == "plain":
        RT.plain("q6_agg")
        return ref.q6_agg(params, shipdate, discount, quantity, extendedprice, mask)
    _check_rows(mask.numel())
    part = torch.empty(4 * _FLAT_BLOCKS, dtype=RT.F32, device=dev)
    out = torch.empty(4, dtype=RT.F32, device=dev)
    lib = _chunk_lib()
    RT.launch(lib, lib.pf_q6_agg, RT.ptr(params), RT.ptr(shipdate),
              RT.ptr(discount), RT.ptr(quantity), RT.ptr(extendedprice),
              RT.ptr(mask), RT.ptr(part), RT.ptr(out), mask.numel(), device=dev,
              count="q6_agg")
    return out


def _check_rows(n: int) -> None:
    if n >= 2**31:
        raise ValueError(f"K5/K6 take fewer than 2**31 rows, got {n}")
