"""Optimizers in plain PyTorch: AdamW (float32 master and moments) and
Adafactor (factored second moment, no first moment, no master).

Port of ``repro/training/optimizer.py``.  States are NamedTuples of dict
trees of tensors, in the reference's layout (one leaf a parameter, the
stacked [n_groups, ...] leaves included, so Adafactor factors a stacked
[n_groups, d] norm scale as a matrix); ``step`` is a 0-d int32 tensor.
Every leaf is computed with the reference's arithmetic, operation for
operation, in float32.

One difference: an update writes the new parameters and the state's trees
IN PLACE (under ``torch.no_grad()``; a parameter keeps its dtype) and
returns them with a new ``step`` tensor, where the reference returns new
trees.  A step then needs no second copy of the state on the card.  The
reference's ZeRO sharding of the state belongs to the sharding slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.uda import tree_leaves, tree_map

_F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor
    master: Any   # fp32 params
    mu: Any       # fp32 first moment
    nu: Any       # fp32 second moment


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any       # row stats (mean over last dim), fp32
    vc: Any       # col stats (mean over second-to-last dim), fp32


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


@torch.no_grad()
def adamw_init(params) -> AdamWState:
    return AdamWState(_step0(params),
                      tree_map(lambda x: x.detach().to(_F32, copy=True), params),
                      tree_map(lambda x: torch.zeros(x.shape, dtype=_F32, device=x.device), params),
                      tree_map(lambda x: torch.zeros(x.shape, dtype=_F32, device=x.device), params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr=1e-4, b1=0.9,
                 b2=0.95, eps=1e-8, wd=0.1):
    step = state.step + 1
    t = step.to(_F32)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t

    def leaf(g, m, v, ma, p):
        g = g.to(_F32)
        m.mul_(b1).add_((1 - b1) * g)                       # b1*m + (1-b1)*g
        v.mul_(b2).add_((1 - b2) * torch.square(g))         # b2*v + (1-b2)*g^2
        u = (m / c1).div_(torch.sqrt(v / c2).add_(eps))     # mhat / (sqrt(vhat) + eps)
        ma.sub_(u.add_(wd * ma).mul_(lr))                   # ma - lr*(u + wd*ma)
        p.copy_(ma)

    tree_map(leaf, grads, state.mu, state.nu, state.master, params)
    return params, AdamWState(step, state.master, state.mu, state.nu)


def _factored_dims(shape):
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


@torch.no_grad()
def adafactor_init(params) -> AdafactorState:
    def vr(x):
        shape = x.shape[:-1] if _factored_dims(x.shape) else x.shape
        return torch.zeros(shape, dtype=_F32, device=x.device)

    def vc(x):
        shape = x.shape[:-2] + x.shape[-1:] if _factored_dims(x.shape) else (1,)
        return torch.zeros(shape, dtype=_F32, device=x.device)

    return AdafactorState(_step0(params), tree_map(vr, params), tree_map(vc, params))


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params, *, lr=1e-4,
                     decay=0.8, eps=1e-30, clip=1.0, wd=0.0):
    step = state.step + 1
    t = step.to(_F32)
    beta = 1.0 - t ** (-decay)

    def leaf(g, p, vr, vc):
        g = g.to(_F32)
        g2 = g * g + eps
        if _factored_dims(g.shape):
            vr.copy_(beta * vr + (1 - beta) * torch.mean(g2, dim=-1))
            vc.copy_(beta * vc + (1 - beta) * torch.mean(g2, dim=-2))
            denom = torch.mean(vr, dim=-1, keepdim=True)
            r = (vr / torch.clamp(denom, min=eps))[..., None]
            u = g * torch.rsqrt(torch.clamp(r * vc[..., None, :], min=eps))
        else:
            vr.copy_(beta * vr + (1 - beta) * g2)
            u = g * torch.rsqrt(torch.clamp(vr, min=eps))
        # update clipping (RMS(u) <= clip)
        rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp(rms / clip, min=1.0)
        p32 = p.to(_F32)
        p.copy_(p32 - lr * (u + wd * p32))

    tree_map(leaf, grads, params, state.vr, state.vc)
    return params, AdafactorState(step, state.vr, state.vc)


def opt_init(params, kind: str):
    return adamw_init(params) if kind == "adamw" else adafactor_init(params)


def opt_update(grads, state, params, kind: str, **kw):
    if kind == "adamw":
        return adamw_update(grads, state, params, **kw)
    return adafactor_update(grads, state, params, **kw)
