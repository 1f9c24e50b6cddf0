"""Plain PyTorch versions of the port's kernels.

The wrappers in ``repro_torch.kernels.fused_agg`` (K1, K2),
``repro_torch.kernels.ops`` (K3-K6) and ``repro_torch.kernels.decode``
(K1's column decode) run these on CPU tensors;
the tests hold them against the JAX reference, and ``chip_smoke.py`` holds
the CUDA kernels against them on the card.  They repeat the kernels'
arithmetic — products formed as in the reference's ``acc_sum`` (``v·w``,
``(v·v)·w``; the group path ``v·(v·w)``), per-chunk totals folded onto the
carry in chunk order — and are no yardstick of speed.  Within one run of
equal ids in a chunk the group kernels add the rows in a fixed tree order
(``csrc/agg_common.cuh``), which differs from ``index_add_``'s here: that is
why the card check holds their sums to ``SUM_RTOL`` and their counters
bit for bit.

Layouts (P partitions, C chunks of L rows, A aggregates, G groups):
  vals  float32 [P, C, L, A]
  w     float32 [P, C, L]      cond · _mask
  gids  int32   [P, C, L]      dense group ids; ids outside [0, G) drop out
  scalar carry  float32 [P, 2A+1]   (sum[A] | sumsq[A] | matched)
  group carry   float32 [P, G, A], [P, G, A], [P, G]
K3 takes the rows of a partition flat (``[P, N, A]``, ``N = C·L``), K4
takes ``vals``/``weight``/``mask`` as ``[P, C, L]``, K5 and K6 flat
``[N]`` columns.
"""
from __future__ import annotations

import torch


def scalar_chunk_totals(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-chunk (Σv·w, Σ(v·v)·w, Σw) as [P, C, 2A+1]."""
    ww = w[..., None]
    return torch.cat([(vals * ww).sum(dim=2), ((vals * vals) * ww).sum(dim=2),
                      w.sum(dim=2, keepdim=True)], dim=-1)


def scalar_round_step(vals: torch.Tensor, w: torch.Tensor,
                      carry: torch.Tensor) -> torch.Tensor:
    """K1, scalar: the carry [P, 2A+1] advanced over the C chunks in order."""
    acc = carry
    part = scalar_chunk_totals(vals, w)
    for c in range(part.shape[1]):
        acc = acc + part[:, c]
    return acc


def scalar_prefix(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K2: the running totals after every chunk, [P, C, 2A+1], from zero."""
    part = scalar_chunk_totals(vals, w)
    out = torch.empty_like(part)
    acc = torch.zeros_like(part[:, 0])
    for c in range(part.shape[1]):
        acc = acc + part[:, c]
        out[:, c] = acc
    return out


def group_round_step(vals, w, gids, carry_s, carry_q, carry_m):
    """K1, group: per chunk, the per-group (Σv·w, Σv·(v·w), Σw) summed from
    zero and then added onto the carry, chunk by chunk — the reference's
    segment sums added to the state."""
    P, C, _, A = vals.shape
    G = carry_s.shape[1]
    vw = vals * w[..., None]
    vq = vals * vw
    g = gids.to(torch.int64)
    keep = (g >= 0) & (g < G)
    idx = g + torch.arange(P, device=g.device)[:, None, None] * G
    s = carry_s.reshape(P * G, A).clone()
    q = carry_q.reshape(P * G, A).clone()
    m = carry_m.reshape(P * G).clone()
    for c in range(C):
        k = keep[:, c].reshape(-1)
        i = idx[:, c].reshape(-1)[k]
        s += torch.zeros_like(s).index_add_(0, i, vw[:, c].reshape(-1, A)[k])
        q += torch.zeros_like(q).index_add_(0, i, vq[:, c].reshape(-1, A)[k])
        m += torch.zeros_like(m).index_add_(0, i, w[:, c].reshape(-1)[k])
    return s.reshape(P, G, A), q.reshape(P, G, A), m.reshape(P, G)


def bundle_round_step(members):
    """K1, bundle: every member advanced as its solo step advances it.
    ``members`` holds ``(vals, w, None, carry)`` for a scalar member and
    ``(vals, w, gids, carry_s, carry_q, carry_m)`` for a group member."""
    return [scalar_round_step(m[0], m[1], m[3]) if m[2] is None
            else group_round_step(*m) for m in members]


def group_agg(vals: torch.Tensor, w: torch.Tensor, gids: torch.Tensor,
              num_groups: int, block_rows: int):
    """K3: per-group (Σv·w, Σv·(v·w), Σw) over ``vals [P, N, A]`` by
    ``gids [P, N]``, from zero.  Each block of ``block_rows`` rows is summed
    per group from zero and added to the totals in block order — K1
    group's step from a zero carry, with the blocks as chunks."""
    P, N, A = vals.shape
    C = N // block_rows
    z = torch.zeros((P, num_groups, A), dtype=vals.dtype, device=vals.device)
    return group_round_step(
        vals.reshape(P, C, block_rows, A), w.reshape(P, C, block_rows),
        gids.reshape(P, C, block_rows), z, z, z[..., 0])


def shard_chunk_partials(vals: torch.Tensor, w: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """K4: per chunk (Σv·wm, Σ(v·v)·wm, Σm, Σwm) with ``wm = w·m``,
    ``[P, C, L]`` -> ``[P, C, 4]``."""
    wm = w * mask
    return torch.stack([(vals * wm).sum(dim=-1), ((vals * vals) * wm).sum(dim=-1),
                        mask.sum(dim=-1), wm.sum(dim=-1)], dim=-1)


def chunk_agg(vals: torch.Tensor, weight: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """K5: (Σv·wm, Σ(v·v)·wm, Σm, Σwm) with ``wm = weight·mask`` over
    flat ``[N]`` f32 columns -> ``[4]``, as the Pallas body forms it
    (the reference's ``ref.py`` oracle takes ``v·w`` instead)."""
    wm = weight * mask
    return torch.stack([(vals * wm).sum(), ((vals * vals) * wm).sum(),
                        mask.sum(), wm.sum()])


def q6_agg(params: torch.Tensor, shipdate: torch.Tensor, discount: torch.Tensor,
           quantity: torch.Tensor, extendedprice: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """K6: Q6 from raw columns — ``sd ∈ [lo, hi) ∧ dc ∈ [dlo, dhi] ∧
    qt == q`` with shipdate converted to f32, value ``ep·dc``, weight
    ``cond·mask`` — then K5's four sums."""
    lo, hi, dlo, dhi, q = params[:5]
    sd = shipdate.to(torch.float32)
    cond = ((sd >= lo) & (sd < hi) & (discount >= dlo) & (discount <= dhi)
            & (quantity == q)).to(torch.float32)
    return chunk_agg(extendedprice * discount, cond * mask, mask)


def decode_dict(codes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Dictionary decode: ``table[code]``, codes widened to int64 (torch's
    int8 is signed) and clamped to the table, as ``pf_decode`` reads it."""
    idx = codes.to(torch.int64).clamp_(0, table.numel() - 1)
    return table[idx]


def decode_bitpacked(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Bit-packed decode: the ``32 // bits`` fields of each int32 word,
    lowest first, as int32 — the trailing axis grows by that factor."""
    lanes = 32 // bits
    shifts = bits * torch.arange(lanes, dtype=torch.int32, device=words.device)
    mask = -1 if bits >= 32 else (1 << bits) - 1
    vals = (words.to(torch.int32)[..., None] >> shifts) & mask
    return vals.reshape(*words.shape[:-1], words.shape[-1] * lanes)
