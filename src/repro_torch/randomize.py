"""Data randomization — paper §4.2.

Port of ``repro/core/randomize.py:36-117``.  On-line aggregation needs
samples: storing the data in random order makes a sequential scan a
without-replacement sample prefix, and the single-estimator model needs the
randomization to be *global* — any prefix of any union of partition scans
is a uniform sample of the whole dataset.

:func:`randomize_global` draws one permutation (the statistical oracle);
:func:`randomize_distributed` is the paper's two-stage algorithm over data
that arrives already partitioned.  Both draw from an explicit
``torch.Generator`` on the columns' device (the draws differ from
``jax.random``'s, so the port is checked statistically and by multiset
against the reference).  :func:`pack_partitions` pads ragged partitions to
the ``[P, C, L]`` layout with a ``_mask`` column that the engine consumes.
"""
from __future__ import annotations

from typing import Dict, List

import torch

Columns = Dict[str, torch.Tensor]


def randomize_global(cols: Columns, generator: torch.Generator,
                     num_partitions: int) -> List[Columns]:
    """One global permutation, then a contiguous split into partitions.

    The permutation is drawn on ``generator``'s device; the columns must
    live there too."""
    n = next(iter(cols.values())).shape[0]
    perm = torch.randperm(n, generator=generator, device=generator.device)
    shuffled = {k: v[perm] for k, v in cols.items()}
    del perm
    bounds = torch.linspace(0, n, num_partitions + 1, dtype=torch.float64)
    bounds = bounds.to(torch.int64).tolist()
    return [{k: v[bounds[i]:bounds[i + 1]] for k, v in shuffled.items()}
            for i in range(num_partitions)]


def randomize_distributed(parts: List[Columns], generator: torch.Generator,
                          num_partitions: int | None = None) -> List[Columns]:
    """Paper §4.2's two-stage algorithm over already-partitioned data.

    Stage 1: every row of every origin partition draws an independent
    uniform target partition, and the rows are exchanged, so that target j
    receives its rows origin by origin, each origin's in their original
    order (the reference's buckets) — one stable sort of the concatenated
    targets, split at the targets' counts.  Stage 2: every target applies
    a fresh random permutation of its rows, which separates the rows it
    received from one origin.

    Draw order on ``generator``: one ``randint`` of each origin's row count,
    origin by origin, then one ``randperm`` per target, target by target.
    Stage 2 draws a permutation, not the reference's float32 sort keys: at
    2^23–2^24 distinct values, millions of keys tie in a target of tens of
    millions of rows, and a stable sort keeps tied rows of one origin
    adjacent — what stage 2 exists to prevent.

    Every column keeps the dtype of ``parts[0]``'s, also in a target that
    receives no rows and for an origin without rows.  Targets are ragged;
    their columns are views of one tensor per column.  The draws and the
    exchange run on ``generator``'s device; the columns must live there
    too (a ``ValueError`` otherwise: nothing is copied between devices)."""
    P = int(num_partitions or len(parts))
    dev = generator.device
    for i, p in enumerate(parts):
        for k, v in p.items():
            if v.device.type != dev.type or dev.index not in (None, v.device.index):
                raise ValueError(
                    f"column {k!r} of origin {i} lives on {v.device}, the generator "
                    f"on {dev}: randomize_distributed runs on the generator's device "
                    "— move the columns there, or draw on a generator of theirs")
    dtypes = {k: v.dtype for k, v in parts[0].items()}
    sizes = [next(iter(p.values())).shape[0] for p in parts]
    # stage 1: targets, origin by origin; a stable sort by target keeps
    # each target's rows origin-major and in their original order
    tgt = torch.cat([torch.randint(0, P, (n,), generator=generator, device=dev)
                     for n in sizes])
    order = torch.sort(tgt, stable=True).indices
    counts = torch.bincount(tgt, minlength=P).tolist()
    del tgt
    # stage 2: one fresh permutation per target, applied through the same
    # gather: row i of target j is row order[off_j + perm_j[i]]
    off = 0
    for n in counts:
        perm = torch.randperm(n, generator=generator, device=dev)
        order[off:off + n] = order[off:off + n][perm]
        off += n
    out: List[Columns] = [{} for _ in range(P)]
    for k, dt in dtypes.items():
        col = torch.cat([p[k].to(dtype=dt) for p in parts])[order]
        for j, piece in enumerate(torch.split(col, counts)):
            out[j][k] = piece
    return out


def pack_partitions(parts: List[Columns], chunk_len: int, *,
                    min_chunks: int | None = None) -> Columns:
    """Pad ragged partitions to ``[P, C, L]`` chunked columns with a _mask.

    Padded slots hold zeros and ``_mask == 0``: they never contribute to any
    GLA state (the uda chunk contract).
    """
    P = len(parts)
    ns = [next(iter(p.values())).shape[0] for p in parts]
    C = max(-(-n // chunk_len) for n in ns)
    if min_chunks is not None:
        C = max(C, min_chunks)
    total = C * chunk_len
    dev = next(iter(parts[0].values())).device
    out: Dict[str, torch.Tensor] = {}
    for k in parts[0]:
        buf = torch.zeros((P, total), dtype=parts[0][k].dtype, device=dev)
        for i, p in enumerate(parts):
            buf[i, : ns[i]] = p[k]
        out[k] = buf.reshape(P, C, chunk_len)
    mask = torch.zeros((P, total), dtype=torch.float32, device=dev)
    for i, n in enumerate(ns):
        mask[i, :n] = 1.0
    out["_mask"] = mask.reshape(P, C, chunk_len)
    return out
