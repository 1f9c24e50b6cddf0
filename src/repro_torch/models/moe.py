"""Mixture-of-Experts layer: the grouped capacity dispatch.

Port of ``repro/models/moe.py``.  Tokens are processed in ``g`` groups
(the reference aligns them with its data-parallel shards).  Within a group
each (token, slot) pair is routed in float32, or float64 for a float64
model (softmax, top-k, the gates renormalised over the k slots), ranked inside its chosen expert in token
order (:func:`_ranks_within_expert`), dropped at the capacity ``cap``,
placed in a dense ``[g, E, cap, d]`` buffer, pushed through the expert
matmuls, and gathered back weighted by its gate.  The Switch-style ``aux``
load-balance term comes back beside the output.

What the port does its own way, with the reference's values:

* top-k is a stable descending sort over the experts, so that a tie puts
  the lower expert first, as ``jax.lax.top_k`` does (``torch.topk`` makes
  no promise);
* the buffer is laid out expert-major (``[E, g, cap, d]``, one matmul
  batch an expert), and only the kept pairs are written, by one
  ``index_put_`` without accumulation: the kept ``(g, e, rank)`` triples
  are unique, so each buffer row is ``0 + x`` as under the reference's
  ``.at[].add``, and no float atomics run.  A dropped pair is written to
  one spare row past the buffer, which the experts never read;
* the gather back reads a kept pair's row and a dropped pair the spare
  row, zeroed, so that no index of the backward repeats except the spare
  row's, whose gradients are zeros: every scatter of the backward is then
  deterministic on the card, and a resumed run is bitwise an uninterrupted
  one.

Left out on purpose: ``_pin_expert_weights``, a GSPMD sharding constraint
that ``moe_mlp`` never calls (the reference's own note measured it
slower); it would mean nothing on one card, as ``pin_batch_activation``
in the port's transformer.

:func:`drop_log` counts the pairs each call drops at capacity, for the
serving phases' reports; nothing else reads it.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import acc_dtype, mlp_act


#: (pairs dropped, pairs) of each moe_mlp call inside :func:`drop_log`
_DROPS: Optional[List[Tuple[torch.Tensor, int]]] = None


@contextlib.contextmanager
def drop_log():
    """Within the block every :func:`moe_mlp` call appends (the pairs it
    dropped at capacity as a 0-d tensor on its device, the pairs it
    routed) to the yielded list; outside it nothing is recorded."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def _ranks_within_expert(eids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """``rank[..., t]`` = the number of earlier pairs in the row that chose
    the same expert.  ``eids [..., T]`` integer; the ranks come back int64.

    A stable sort of the pair indices by expert, then each position's
    distance from the start of its run of equal experts (a running maximum
    of the run starts), scattered back to token order."""
    T = eids.shape[-1]
    order = torch.argsort(eids, dim=-1, stable=True)
    e_sorted = torch.gather(eids, -1, order)
    iota = torch.arange(T, device=eids.device).expand_as(order)
    is_start = torch.ones_like(order, dtype=torch.bool)
    is_start[..., 1:] = e_sorted[..., 1:] != e_sorted[..., :-1]
    run_start = torch.cummax(torch.where(is_start, iota, 0), dim=-1).values
    return torch.zeros_like(order).scatter_(-1, order, iota - run_start)


def dispatch_shape(T: int, groups: int, cfg) -> Tuple[int, int, int]:
    """(groups g, tokens a group Tg, capacity cap) for T tokens: ``g`` is
    ``groups`` lowered until it divides T; ``cap = min(max(8, ceil(Tg·k·
    factor / E)), Tg)``, the reference's expression."""
    E, k = cfg.num_experts, cfg.experts_per_token
    g = min(groups, T)
    while T % g:
        g -= 1
    Tg = T // g
    cap = max(8, int(-(-Tg * k * cfg.expert_capacity_factor // E)))
    return g, Tg, min(cap, Tg)


def route(router, xf, cfg, cap: int):
    """The routing of ``xf [g, Tg, d]``: (probs [g, Tg, E] float32 (or
    wider), eidx [g, Tg, k] int64, ranks [g, Tg·k] int64, keep [g, Tg·k]
    in probs' dtype — the renormalised gate where the rank is under
    ``cap``, else 0)."""
    g, Tg, _ = xf.shape
    k = cfg.experts_per_token
    logits = xf @ router.to(xf.dtype)
    probs = torch.softmax(logits.to(acc_dtype(xf)), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = vals[..., :k], idx[..., :k]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    ranks = _ranks_within_expert(eidx.reshape(g, Tg * k), cfg.num_experts)
    keep = (ranks < cap).to(probs.dtype) * gate.reshape(g, Tg * k)
    return probs, eidx, ranks, keep


def moe_mlp(p, x, cfg, *, groups: int):
    """``x [B, S, d] -> ([B, S, d], aux)`` through the top-k routed experts.

    ``p``: ``router [d, E]`` (float32), ``wi``/``wg [E, d, f]``, ``wo [E, f,
    d]``; ``aux`` is a float32 (or wider) scalar."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    g, Tg, cap = dispatch_shape(B * S, groups, cfg)
    xf = x.reshape(g, Tg, d)
    probs, eidx, ranks, keep = route(p["router"], xf, cfg, cap)
    kept = ranks < cap
    if _DROPS is not None:
        _DROPS.append((torch.sum(~kept), kept.numel()))

    # dispatch: each kept pair to row (e, g, rank) of the expert-major
    # buffer, a dropped one to the spare row E·g·cap
    e_flat = eidx.reshape(g, Tg * k)
    gi = torch.arange(g, device=x.device)[:, None]
    spare = E * g * cap
    rows = torch.where(kept, (e_flat * g + gi) * cap + ranks, spare).reshape(-1)
    pairs = xf[:, :, None, :].expand(g, Tg, k, d).reshape(-1, d)
    buf = torch.zeros(spare + 1, d, dtype=x.dtype, device=x.device)
    buf = buf.index_put_((rows,), pairs)
    be = buf[:spare].view(E, g * cap, d)

    # the experts: [E, g·cap, d] x [E, d, f]
    h = mlp_act(torch.bmm(be, p["wi"]), cfg.mlp_act)
    if cfg.mlp_gated:
        h = h * torch.bmm(be, p["wg"])
    out_buf = torch.bmm(h, p["wo"]).view(spare, d)

    # combine: each pair's expert output, weighted by its gate (0 if dropped)
    out_buf = torch.cat([out_buf, out_buf.new_zeros(1, d)])
    out_pairs = out_buf[rows].view(g, Tg * k, d) * keep[..., None].to(x.dtype)
    out = torch.sum(out_pairs.view(g, Tg, k, d), dim=2)
    # the auxiliary load-balance loss (Switch-style)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(eidx[..., 0], E).to(probs.dtype), dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, d), aux
