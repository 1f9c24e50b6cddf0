"""The ``kernel_cols`` and chunk-aggregate kernels on Hopper — port of
``repro/kernels/ops.py:46-149``.

  K3 :func:`group_agg`             per-group sums of a round-slice's rows
                                   (``csrc/group_agg.cu``, ``pf_group_agg``).
                                   Serves ``scan.kernel_round_delta`` and
                                   ``scan.bundle_round_deltas``: group-by
                                   GLAs and bundles whose fused contract
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
    return RT.bind(_build.load("group_agg"), pf_group_agg=(7, 7))


#: the most carry floats of one window of the group step's fold (32·s ids,
#: 2A+1 columns) where a lane owns more than one id (``csrc/agg_common.cuh``
#: ``kFoldSpanFloats``): 12 KB, so that two blocks of 8 warps, each holding
#: a window's columns in shared memory, fit an SM
FOLD_SPAN_FLOATS = 3072


def group_step_span(L: int, A: int, G: int) -> int:
    """Ids a lane of the group step's fold owns, so that a window spans
    ``32·s`` ids (``csrc/agg_common.cuh`` ``step_span``): the largest power
    of two ``<= G / 4L`` (1 where ``G < 8L``), so that a window takes at
    most 8 of a chunk's ``L`` rows on average, whose window of ``2A+1``
    floats an id fits :data:`FOLD_SPAN_FLOATS`."""
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


def group_agg(vals: torch.Tensor, weight: torch.Tensor, gids: torch.Tensor, *,
              num_groups: int, block_rows: int):
    """K3: ``vals [P, N]`` or ``[P, N, A]`` f32, ``weight [P, N]`` f32
    (predicate · ``_mask``), ``gids [P, N]`` i32 -> ``(sums [P, G, A],
    sumsqs [P, G, A], matched [P, G])`` from zero.  Ids outside [0, G) drop
    out.  ``N`` must be a multiple of ``block_rows``: each block of rows is
    summed per group from zero and added to the totals in block order, so
    with ``block_rows`` = the chunk length the totals keep the chunk-by-chunk
    association of the scan."""
    if isinstance(vals, torch.Tensor) and vals.ndim == 2:
        vals = vals.unsqueeze(-1)
    if not isinstance(vals, torch.Tensor) or vals.ndim != 3:
        raise ValueError("vals must be a [P, N] or [P, N, A] tensor")
    P, N, A = vals.shape
    dev = vals.device
    RT.check("vals", vals, RT.F32, (P, N, A), dev)
    RT.check("weight", weight, RT.F32, (P, N), dev)
    RT.check("gids", gids, RT.I32, (P, N), dev)
    if min(P, A, num_groups, block_rows) < 1 or N % block_rows:
        raise ValueError(f"group_agg needs P, A, G, block_rows >= 1 and N % "
                         f"block_rows == 0, got N={N}, block_rows={block_rows}")
    if RT.route(dev) == "plain":
        RT.plain("group_agg")
        return ref.group_agg(vals, weight, gids, num_groups, block_rows)
    if block_rows > RT.MAX_GROUP_ROWS:
        raise ValueError(f"group_agg sorts a block in shared memory: "
                         f"block_rows={block_rows} exceeds {RT.MAX_GROUP_ROWS}")
    sums = torch.empty((P, num_groups, A), dtype=RT.F32, device=dev)
    sumsqs = torch.empty_like(sums)
    matched = torch.empty((P, num_groups), dtype=RT.F32, device=dev)
    C = N // block_rows
    tile = group_step_tile(C, block_rows, [(A, num_groups)])
    scratch = group_step_scratch(P, C, block_rows, A, num_groups, tile, dev)
    lib = _group_lib()
    RT.launch(lib, lib.pf_group_agg, RT.ptr(vals), RT.ptr(weight), RT.ptr(gids),
              RT.ptr(sums), RT.ptr(sumsqs), RT.ptr(matched), RT.ptr(scratch), P,
              N, block_rows, A, num_groups, tile,
              group_step_words(block_rows, A, num_groups), device=dev,
              count="group_agg")
    count_wide_folds([(A, num_groups)], block_rows)
    return sums, sumsqs, matched


def count_wide_folds(members, L: int) -> None:
    """Add the group members ((A, G) each) of a launch over chunks of ``L``
    rows whose fold takes more than one id a lane to the ``pfola.fold.wide``
    counter (recorded only while ``obs`` records)."""
    n = sum(group_step_span(L, A, G) > 1 for A, G in members)
    if n:
        obs.count("pfola.fold.wide", n)


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
