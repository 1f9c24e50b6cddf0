"""Sketch-backed GLAs — COUNT DISTINCT, quantiles, heavy hitters.

Port of ``repro/core/sketch.py``.  Each sketch is a new merge monoid behind
the same Init/Accumulate/Merge/Estimate surface, so it composes with
bundles, sessions, streaming sources and checkpoints, and, when the monoid
is additive, with ``mesh=`` (``repro_torch.sharded``):

  * :func:`make_count_distinct_gla` — HLL-style leading-zero registers.
    Merge is elementwise **max**: associative, commutative, idempotent,
    but not additive, so it runs in one process only (the sharded path and
    ``FaultPolicy`` refuse it) and on the scan paths only (it publishes no
    kernel contract).
  * :func:`make_quantile_gla` — fixed-bin histogram CDF with
    Dvoretzky–Kiefer–Wolfowitz bands.  Additive.
  * :func:`make_heavy_hitters_gla` — count-min sketch over a candidate id
    set, Horvitz–Thompson-scaled with the CM overcount bound.  Additive.

As every GLA of the port, ``accumulate`` takes batched states and chunks:
columns ``[B, L]`` (``[P, lanes, L/lanes]`` with lanes) and state leaves
with the same leading axes; ``terminate``/``estimate`` broadcast over any
leading axes (rounds).  Sketches are folded along the last axis into a
fresh tensor and added to (or maxed with) the state, never written into
it: ``scan.stack_init`` hands out expanded views.  The histogram and CMS
rows of one chunk are counted in int32 (the weights are the 0/1 Filter
predicate times the mask) and added to the float32 state: integer-valued,
so bitwise the reference's float ``segment_sum``, and no float atomics on
the card.  Keys are hashed as the reference's uint32 arithmetic, held in
int64 (:func:`repro_torch.gla.mul32`).

Estimation semantics under OLA: each sketch summarizes the rows scanned so
far, and its estimate converges to the exact answer as the scan completes.
COUNT DISTINCT is a lower-bound-style estimator mid-scan; its interval
covers sketch error, not sampling error (``info["frac"]`` says how much of
the data backs it).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import estimators as E
from repro_torch.gla import _BUCKET_MULT, mul32
from repro_torch.uda import GLA, Chunk, Estimate, tree_map

_F32 = torch.float32


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Keys as the reference's ``astype(uint32)`` casts them, held in int64
    in [0, 2**32): int32 -1 -> 0xFFFFFFFF; float keys truncate."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer (xorshift-multiply) over uint32 keys; int64 result
    in [0, 2**32)."""
    h = mul32(_u32(x), _BUCKET_MULT)
    h = h ^ (h >> 15)
    h = mul32(h, 0x2C1B3C6D)
    return h ^ (h >> 12)


def _const(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device.  Dividing by it is a true
    division on the card too (a Python scalar divisor becomes a multiply by
    its reciprocal there)."""
    return torch.as_tensor(x, dtype=_F32, device=like.device)


def _live(chunk: Chunk) -> torch.Tensor:
    return chunk["_mask"].to(_F32).sum(dim=-1)


def _count(w: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Per-row weights ``w [..., L]`` (0/1) summed by ``idx [..., K, L]``
    (or ``[..., L]``) into float32 ``[..., K, n]`` (or ``[..., n]``),
    counted in int32."""
    src = w.to(torch.int32)
    if idx.ndim > w.ndim:
        src = src.unsqueeze(-2).expand(idx.shape)
    out = torch.zeros((*idx.shape[:-1], n), dtype=torch.int32, device=w.device)
    return out.scatter_add_(-1, idx, src).to(_F32)


# ---------------------------------------------------------------------------
# COUNT DISTINCT — HLL-style max-merge registers
# ---------------------------------------------------------------------------

class HLLState(NamedTuple):
    registers: torch.Tensor  # [..., m] f32 max leading-zero ranks
    scanned: torch.Tensor  # [...] |S| live rows folded in


def make_count_distinct_gla(
    key: Callable[[Chunk], torch.Tensor],
    *,
    d_total: float,
    log2m: int = 12,
    cond: Optional[Callable[[Chunk], torch.Tensor]] = None,
) -> GLA:
    """COUNT(DISTINCT key(d)) [WHERE cond(d)] via 2**log2m HLL registers.

    Registers hold the max rank (leading-zero run + 1) of hashed keys per
    bucket; merge is elementwise max, so duplicate keys — within a chunk,
    across chunks, across partitions — collapse idempotently.  Standard
    error is ~1.04/sqrt(m) relative (Flajolet et al.), reported as a normal
    interval around the bias-corrected estimate with the linear-counting
    small-range correction.
    """
    m = 1 << log2m
    alpha = 0.7213 / (1.0 + 1.079 / m)  # bias correction, m >= 128

    def init(device):
        return HLLState(registers=torch.zeros((m,), dtype=_F32, device=device),
                        scanned=torch.zeros((), dtype=_F32, device=device))

    def accumulate(state: HLLState, chunk: Chunk) -> HLLState:
        w = chunk["_mask"]
        if cond is not None:
            w = cond(chunk) * w
        h = _mix32(key(chunk))
        bucket = h & (m - 1)
        # clz32(rest) = 32 - bit_length(rest), and frexp's exponent is the
        # exact bit length of an integer below 2**53; rest == 0 has
        # exponent 0, which gives the reference's rank 32 - log2m + 1
        _, bits = torch.frexp((h >> log2m).to(torch.float64))
        rank = (32 - log2m + 1 - bits).to(_F32) * w.to(_F32)  # dead rows: 0
        regs = torch.zeros((*rank.shape[:-1], m), dtype=_F32, device=rank.device)
        regs.scatter_reduce_(-1, bucket, rank, "amax")
        return HLLState(registers=torch.maximum(state.registers, regs),
                        scanned=state.scanned + _live(chunk))

    def merge(a: HLLState, b: HLLState) -> HLLState:
        return HLLState(registers=torch.maximum(a.registers, b.registers),
                        scanned=a.scanned + b.scanned)

    def hll_point(regs):
        raw = _const(alpha * m * m, regs) / torch.exp2(-regs).sum(dim=-1)
        zeros = (regs == 0).to(_F32).sum(dim=-1)
        linear = m * torch.log(_const(m, regs) / torch.clamp(zeros, min=1.0))
        return torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)

    def terminate(state: HLLState):
        return hll_point(state.registers)

    def estimate(state: HLLState, confidence, ctx=None) -> Estimate:
        regs = state.registers
        est = hll_point(regs)
        rel = (_const(1.04, regs) / torch.sqrt(_const(m, regs))).expand(est.shape)
        half = E.zq(confidence).to(regs.device) * rel * est
        frac = state.scanned / torch.clamp(_const(d_total, regs), min=1.0)
        return Estimate(est, est - half, est + half,
                        info={"rel_err": rel, "frac": frac})

    return GLA(init=init, accumulate=accumulate, merge=merge,
               terminate=terminate, estimate=estimate,
               merge_is_additive=False,  # max monoid: one process only
               name=f"hll-distinct-m{m}")


# ---------------------------------------------------------------------------
# Quantiles — fixed-bin histogram CDF with DKW bands (additive)
# ---------------------------------------------------------------------------

class HistState(NamedTuple):
    counts: torch.Tensor  # [..., bins] f32 in-range predicate-matching rows
    scanned: torch.Tensor
    matched: torch.Tensor


def make_quantile_gla(
    value: Callable[[Chunk], torch.Tensor],
    *,
    lo: float,
    hi: float,
    d_total: float,
    bins: int = 256,
    q: float = 0.5,
    cond: Optional[Callable[[Chunk], torch.Tensor]] = None,
) -> GLA:
    """q-quantile of value(d) [WHERE cond(d)] over a known range [lo, hi).

    The histogram CDF is an empirical distribution over the sample scanned
    so far; the DKW inequality bounds sup|F_n - F| by
    sqrt(ln(2/(1-conf)) / (2 n)), so the interval is the value-space span of
    the (q ± eps)-quantiles plus one bin of discretization.  Counts are
    additive: this monoid runs on every path and under ``mesh=``.
    """
    B = int(bins)
    lo32 = np.float32(lo)
    width32 = np.float32((float(hi) - float(lo)) / B)
    # float32 arithmetic throughout, as the reference's edges
    edges = torch.from_numpy(lo32 + width32 * np.arange(B + 1, dtype=np.float32))

    def init(device):
        z = torch.zeros((), dtype=_F32, device=device)
        return HistState(counts=torch.zeros((B,), dtype=_F32, device=device),
                         scanned=z, matched=z.clone())

    def accumulate(state: HistState, chunk: Chunk) -> HistState:
        v = value(chunk).to(_F32)
        w = chunk["_mask"].to(_F32)
        if cond is not None:
            w = cond(chunk).to(_F32) * w
        b = torch.floor((v - _const(lo32, v)) / _const(width32, v))
        b = torch.clamp(b, 0, B - 1).to(torch.int64)
        return HistState(counts=state.counts + _count(w, b, B),
                         scanned=state.scanned + _live(chunk),
                         matched=state.matched + w.sum(dim=-1))

    def merge(a, b):
        return tree_map(torch.add, a, b)

    def quantile_value(cdf, p):
        # first bin upper edge where the CDF reaches p (conservative)
        idx = (cdf < p[..., None]).to(torch.int32).sum(dim=-1)
        return edges.to(cdf.device)[torch.clamp(idx, 0, B).long()]

    def cdf_of(state: HistState):
        return torch.cumsum(state.counts, dim=-1) / torch.clamp(
            state.matched, min=1.0)[..., None]

    def terminate(state: HistState):
        return quantile_value(cdf_of(state), _const(q, state.counts))

    def estimate(state: HistState, confidence, ctx=None) -> Estimate:
        n = state.matched
        cdf = cdf_of(state)
        conf = _const(confidence, n)
        eps = torch.sqrt(
            torch.log(_const(2.0, n) / torch.clamp(1.0 - conf, min=1e-9))
            / (2.0 * torch.clamp(n, min=1.0)))
        q32 = _const(q, n)
        est = quantile_value(cdf, q32)
        # the crossing bin's lower edge; the true quantile sits anywhere in
        # that bin, so both band edges get the one-bin margin
        lo_v = quantile_value(cdf, q32 - eps) - _const(width32, n)
        hi_v = quantile_value(cdf, q32 + eps) + _const(width32, n)
        # n == 0: no order statistics at all — the full range
        lo_v = torch.where(n > 0, lo_v, _const(-math.inf, n))
        hi_v = torch.where(n > 0, hi_v, _const(math.inf, n))
        frac = state.scanned / torch.clamp(_const(d_total, n), min=1.0)
        return Estimate(est, lo_v, hi_v, info={"eps": eps, "frac": frac})

    return GLA(init=init, accumulate=accumulate, merge=merge,
               terminate=terminate, estimate=estimate,
               merge_is_additive=True, name=f"quantile-q{q}-b{B}")


# ---------------------------------------------------------------------------
# Heavy hitters — count-min sketch over candidate ids (additive)
# ---------------------------------------------------------------------------

class CMSState(NamedTuple):
    table: torch.Tensor  # [..., depth, width] f32 hashed counts
    scanned: torch.Tensor
    matched: torch.Tensor


# distinct odd multipliers per CMS row (pairwise-independent enough for the
# standard CM overcount guarantee at small depth)
_CMS_MULTS = (2654435761, 2246822519, 3266489917, 668265263, 374761393)


def _cms_buckets(k: torch.Tensor, W: int, D: int) -> torch.Tensor:
    """Each row's bucket of keys ``k [..., n]``: int64 ``[..., D, n]``."""
    u = _u32(k)
    return torch.stack([(mul32(u, _CMS_MULTS[d]) ^ (u >> 16)) & (W - 1)
                        for d in range(D)], dim=-2)


def make_heavy_hitters_gla(
    key: Callable[[Chunk], torch.Tensor],
    candidates,
    *,
    d_total: float,
    width: int = 1024,
    depth: int = 4,
    cond: Optional[Callable[[Chunk], torch.Tensor]] = None,
) -> GLA:
    """Per-candidate frequency estimates via a count-min sketch.

    ``candidates`` is the static id array to report (the heavy-hitter
    shortlist).  Each CMS cell overcounts by at most e/width of the total
    mass w.h.p.; the reported interval is the HT-scaled min-row count minus
    that overcount (lower) to the HT-scaled min-row count plus the sampling
    half-width (upper).  Counts are additive: every path and ``mesh=``.
    """
    W, D = int(width), int(depth)
    if D > len(_CMS_MULTS):
        raise ValueError(f"depth <= {len(_CMS_MULTS)} supported")
    # the candidates' buckets, once, on the host; moved beside the table
    cand = _cms_buckets(torch.as_tensor(candidates).cpu(), W, D)  # [D, n]

    def init(device):
        z = torch.zeros((), dtype=_F32, device=device)
        return CMSState(table=torch.zeros((D, W), dtype=_F32, device=device),
                        scanned=z, matched=z.clone())

    def accumulate(state: CMSState, chunk: Chunk) -> CMSState:
        w = chunk["_mask"].to(_F32)
        if cond is not None:
            w = cond(chunk).to(_F32) * w
        rows = _count(w, _cms_buckets(key(chunk), W, D), W)  # [..., D, W]
        return CMSState(table=state.table + rows,
                        scanned=state.scanned + _live(chunk),
                        matched=state.matched + w.sum(dim=-1))

    def merge(a, b):
        return tree_map(torch.add, a, b)

    def counts(table):
        idx = cand.to(table.device)
        per_row = torch.gather(table, -1, idx.expand(*table.shape[:-2], *idx.shape))
        return per_row.min(dim=-2).values  # [..., n]

    def terminate(state: CMSState):
        return counts(state.table)

    def estimate(state: CMSState, confidence, ctx=None) -> Estimate:
        sample = counts(state.table)  # [..., n]
        s = torch.clamp(state.scanned, min=1.0)
        d = _const(d_total, s)
        scale = d / s
        est = sample * scale[..., None]
        overcount = _const(math.e / W, s) * state.matched * scale
        # sampling error on a {0,1}-valued count: binomial half-width
        p = sample / s[..., None]
        var = ((d * torch.clamp(d - state.scanned, min=0.0))[..., None]
               * p * torch.clamp(1.0 - p, min=0.0) / s[..., None])
        half = E.zq(confidence).to(s.device) * torch.sqrt(var)
        frac = state.scanned / torch.clamp(d, min=1.0)
        return Estimate(est, est - half - overcount[..., None], est + half,
                        info={"overcount": overcount, "frac": frac})

    return GLA(init=init, accumulate=accumulate, merge=merge,
               terminate=terminate, estimate=estimate,
               merge_is_additive=True, name=f"cms-hh-w{W}d{D}")
