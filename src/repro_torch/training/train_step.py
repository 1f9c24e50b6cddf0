"""Training step: loss, grads (microbatched accumulation), optimizer update.

Port of ``repro/training/train_step.py``.  ``make_train_step(cfg)`` returns
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``:
the model's parameters (``Transformer.params``, the reference's stacked
tree) and the optimizer state are updated in place and returned.

Gradient accumulation over ``cfg.train_microbatches`` is a loop in
microbatch order (the reference's ``lax.scan``), so the activation
footprint of a step is one microbatch's; with more than one microbatch the
grads accumulate in float32.  The metrics carry the per-step loss sum,
sum of squares and count over microbatches that the confidence-bounded
accumulation (``repro_torch.training.grad_estimator``) reads.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.cost import trips
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as O
from repro_torch.uda import tree_leaves, tree_map

AUX_LOSS_WEIGHT = 0.01
_F32 = torch.float32


class _GradDtypeBoundary(torch.autograd.Function):
    """Identity forward; casts the cotangent back to x's dtype.

    The cross-entropy tail runs in float32; the boundary keeps the backward
    residual stream in the activations' dtype (bf16), as the reference's
    ``_grad_dtype_boundary`` does."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_dtype_boundary(x: torch.Tensor) -> torch.Tensor:
    return _GradDtypeBoundary.apply(x)


def shift_targets(cfg: ArchConfig, batch: Dict[str, torch.Tensor], seq_total: int):
    """(targets, mask) aligned with the model's hidden-state positions.

    Hidden position j predicts the token at input position j+1.  For VLM
    inputs the first ``P = seq_total - S_txt`` positions are patch
    embeddings; only text transitions are scored."""
    tokens = batch["tokens"]
    B, S_txt = tokens.shape
    P = seq_total - S_txt
    targets = torch.zeros((B, seq_total), dtype=torch.int32, device=tokens.device)
    targets[:, P:P + S_txt - 1] = tokens[:, 1:]                 # h_{P+i} -> tok_{i+1}
    mask = torch.zeros((B, seq_total), dtype=_F32, device=tokens.device)
    mask[:, P:P + S_txt - 1] = 1.0
    return targets, mask


def loss_fn(model, cfg: ArchConfig, batch):
    """-> (the objective ``ce + AUX_LOSS_WEIGHT * aux``, ``ce``)."""
    x, aux, _ = model.forward(batch)
    x = grad_dtype_boundary(x)
    targets, mask = shift_targets(cfg, batch, x.shape[1])
    ce = T.xent_loss(model, cfg, x, targets, mask)
    return ce + AUX_LOSS_WEIGHT * aux, ce


def value_and_grad(model, cfg: ArchConfig, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, ce), grads),
    the grads a tree like ``model.params`` in the parameters' dtypes."""
    params = model.params
    with torch.enable_grad():
        loss, ce = loss_fn(model, cfg, batch)
        leaves = tree_leaves(params)
        gs = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), ce.detach()), _like(params, gs)


def _like(tree, it):
    if isinstance(tree, dict):
        return {k: _like(v, it) for k, v in tree.items()}
    return next(it)


def _split_micro(batch, m: int):
    """[B, ...] -> [M, B/M, ...].  The reference's sharding constraint on
    the batch axis is GSPMD's; the port's sharding slice owns that."""
    return {k: x.reshape(m, x.shape[0] // m, *x.shape[1:]) for k, x in batch.items()}


def microbatch_count(cfg: ArchConfig, batch: int, dp_size: int = 1) -> int:
    """``cfg.train_microbatches`` lowered until each microbatch of a
    ``batch`` still splits evenly over ``dp_size`` data shards."""
    M = cfg.train_microbatches
    while M > 1 and (batch % M or (batch // M) % dp_size):
        M -= 1
    return M


def make_train_step(cfg: ArchConfig, *, lr: float = 1e-4, clip: float = 1.0,
                    dp_size: int = 1):
    """Build the train step for an architecture.

    ``dp_size``: data-parallel shard count of the global batch — the
    microbatch count is lowered until each microbatch still splits evenly
    over it."""

    def train_step(model, opt_state, batch):
        M = microbatch_count(cfg, batch["tokens"].shape[0], dp_size)

        if M == 1:
            (_, ce), grads = value_and_grad(model, cfg, batch)
            ce_sum, ce_sumsq = ce, ce * ce
            nmb = torch.ones((), dtype=_F32, device=ce.device)
        else:
            micro = _split_micro(batch, M)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device),
                             model.params)
            ce_sum = ce_sumsq = torch.zeros((), dtype=_F32, device=model.device)
            for i in trips(M):     # identical trips: repro_torch.cost scales them
                (_, ce), gi = value_and_grad(model, cfg, {k: v[i] for k, v in micro.items()})
                for a, g in zip(tree_leaves(grads), tree_leaves(gi)):
                    a.add_(g.to(_F32) / M)
                del gi
                ce_sum, ce_sumsq = ce_sum + ce, ce_sumsq + ce * ce
            ce = ce_sum / M
            nmb = torch.full((), float(M), dtype=_F32, device=ce.device)

        leaves = tree_leaves(grads)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(_F32))) for g in leaves))
        if clip is not None:
            scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
            for g in leaves:
                g.copy_(g.to(_F32) * scale)
        _, opt_state = O.opt_update(grads, opt_state, model.params, cfg.optimizer, lr=lr)
        metrics = {
            "loss": ce,
            "loss_sum": ce_sum,
            "loss_sumsq": ce_sumsq,
            "num_micro": nmb,
            "grad_norm": gnorm,
        }
        return model, opt_state, metrics

    return train_step


def init_train_state(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16, device="cuda"):
    """A model with trainable parameters drawn from ``seed``
    (``transformer.init_model``) and its optimizer state."""
    model = T.init_model(cfg, seed=seed, dtype=dtype, device=device).requires_grad_(True)
    return model, O.opt_init(model.params, cfg.optimizer)
