"""The legacy ``kernel_cols`` kernels on Hopper — port of
``repro/kernels/ops.py:64-95,113-149``.

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

The reference pads G to 128 and A to 8 for the TPU's matrix unit and
launches once per partition; here the shapes stay as they are and one
launch covers every partition.  On CPU tensors the wrappers run the plain
versions in ``kernels/ref.py``; on CUDA tensors they launch the kernel or
raise (``kernels/_runtime.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import _runtime as RT


def _group_lib():
    return RT.bind(_build.load("group_agg"), pf_group_agg=(6, 5))


def _chunk_lib():
    return RT.bind(_build.load("chunk_agg"), pf_shard_partials=(4, 3))


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
        return ref.group_agg(vals, weight, gids, num_groups, block_rows)
    if block_rows > RT.MAX_GROUP_ROWS:
        raise ValueError(f"group_agg sorts a block in shared memory: "
                         f"block_rows={block_rows} exceeds {RT.MAX_GROUP_ROWS}")
    sums = torch.empty((P, num_groups, A), dtype=RT.F32, device=dev)
    sumsqs = torch.empty_like(sums)
    matched = torch.empty((P, num_groups), dtype=RT.F32, device=dev)
    lib = _group_lib()
    RT.launch(lib, lib.pf_group_agg, RT.ptr(vals), RT.ptr(weight), RT.ptr(gids),
              RT.ptr(sums), RT.ptr(sumsqs), RT.ptr(matched), P, N, block_rows, A,
              num_groups, device=dev, count="group_agg")
    return sums, sumsqs, matched


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
        return ref.shard_chunk_partials(v, w, m)
    P, C, L = mask.shape
    out = torch.empty((P, C, 4), dtype=RT.F32, device=dev)
    lib = _chunk_lib()
    RT.launch(lib, lib.pf_shard_partials, RT.ptr(v), RT.ptr(w), RT.ptr(m),
              RT.ptr(out), P, C, L, device=dev, count="shard_chunk_partials")
    return out
