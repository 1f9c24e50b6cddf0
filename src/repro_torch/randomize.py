"""Data randomization — paper §4.2.

Port of ``repro/core/randomize.py:36-117``.  On-line aggregation needs
samples: storing the data in random order makes a sequential scan a
without-replacement sample prefix, and the single-estimator model needs the
randomization to be *global* — any prefix of any union of partition scans
is a uniform sample of the whole dataset.

:func:`randomize_global` draws one permutation from an explicit
``torch.Generator`` (the draws differ from ``jax.random``'s; the port's
randomizer is checked statistically against the reference).
:func:`pack_partitions` pads ragged partitions to the ``[P, C, L]`` layout
with a ``_mask`` column that the engine consumes.
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
