"""On-line aggregation over model computations — the PF-OLA ↔ LM bridge.

Port of ``repro/core/metrics.py``.  The paper's query (1) is
SUM(func(d)) WHERE cond(d).  Substituting ``func(d) = loss(params, d)``
makes dataset-level evaluation an on-line aggregation problem: stream eval
batches through the model, keep the (sum, sumSq, count) GLA state, and
report an anytime estimate of the full-corpus loss with confidence bounds,
stopping early once the bounds are tight.  ``cond`` becomes a
data-selection predicate, and per-group statistics are the paper's query
(5).

These constructors return standard GLAs over :func:`repro_torch.gla.make_sum_gla`
and :func:`repro_torch.gla.make_groupby_gla`, so they run every path those
do, the fused kernels (K1, K2) included: only ``func`` changed.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.gla import make_groupby_gla, make_sum_gla
from repro_torch.uda import GLA, Chunk


def _with_count(loss_per_example):
    def func2(chunk):
        lpe = loss_per_example(chunk)
        return torch.stack([lpe, torch.ones_like(lpe)], dim=-1)

    return func2


def make_loss_gla(
    loss_per_example: Callable[[Chunk], torch.Tensor],
    *,
    d_total: float,
    cond: Optional[Callable[[Chunk], torch.Tensor]] = None,
    estimator: str = "single",
    dtype=torch.float32,
) -> GLA:
    """GLA whose func is a per-example model loss.

    ``loss_per_example(chunk) -> [..., L]`` runs the model forward on the
    chunk's examples.  The mean loss over the predicate-selected subset is
    SUM/COUNT — both estimated at once by stacking two aggregates (func and
    the constant 1), the paper's AVERAGE construction (§4.3).

    The port's states are float32 (``make_sum_gla`` takes no dtype), so
    ``dtype`` must be ``torch.float32``; any other is a ValueError.
    """
    if dtype != torch.float32:
        raise ValueError(
            f"make_loss_gla: the port's SumState is float32, got dtype={dtype!r}")
    c = cond if cond is not None else (
        lambda chunk: torch.ones_like(chunk["_mask"]))
    return make_sum_gla(_with_count(loss_per_example), c, d_total=d_total,
                        estimator=estimator, num_aggs=2).with_(name="loss-gla")


def mean_with_bounds(est) -> tuple:
    """Turn the 2-aggregate (sum, count) Estimate into mean ± half-width,
    as numpy arrays (one entry per round).

    Ratio-estimator bounds via the first-order delta method: the count
    estimate is near-exact relative to the loss spread, so half-width(mean)
    ≈ half-width(sum)/count_estimate.  Exact at full scan (variance 0).
    """
    def host(x):
        return torch.as_tensor(x).detach().cpu().numpy()

    est_sum, est_cnt = host(est.estimate).T
    lo_sum = host(est.lower).T[0]
    hi_sum = host(est.upper).T[0]
    cnt = np.maximum(est_cnt, 1.0)
    mean = est_sum / cnt
    half = (hi_sum - lo_sum) / 2.0 / cnt
    return mean, mean - half, mean + half


def lm_loss_per_example(model, seq: int) -> Callable[[Chunk], torch.Tensor]:
    """``func(d) = loss(params, d)`` over a token corpus stored one column
    a position (``t0`` .. ``t{seq-1}``, one row an example), as
    ``examples/online_eval.py`` lays it out: each example's mean
    next-token negative log-likelihood under ``model`` (a
    ``repro_torch.models.transformer.Transformer``).

    The fused kernels' pre-pass (``kernels.fused_agg.project``) calls the
    closure once on all the columns it scans — the whole ``[P, C, L]``
    shard under ``run_query`` — so the closure flattens the leading axes
    and runs the model over bounded blocks of examples
    (``Transformer.example_nll``), never over all of them at once.

    An MoE model is refused here, before any scan (a ``ValueError``): under
    the experts' capacity an example's loss depends on the examples that
    share its forward (``transformer.check_per_example``)."""
    from repro_torch.models.transformer import check_per_example

    check_per_example(model.cfg)

    def loss_per_example(chunk):
        tt = torch.stack([chunk[f"t{j}"] for j in range(seq)], dim=-1)
        return model.example_nll(tt.reshape(-1, seq)).reshape(tt.shape[:-1])

    return loss_per_example


def make_groupwise_loss_gla(
    loss_per_example: Callable[[Chunk], torch.Tensor],
    group: Callable[[Chunk], torch.Tensor],
    *,
    num_groups: int,
    d_total: float,
    estimator: str = "single",
) -> GLA:
    """Per-domain / per-bucket loss statistics with simultaneous bounds —
    paper query (5) with func = loss."""
    def cond(chunk):
        return torch.ones_like(chunk["_mask"])

    return make_groupby_gla(_with_count(loss_per_example), cond, group,
                            num_groups=num_groups, d_total=d_total,
                            estimator=estimator,
                            num_aggs=2).with_(name="groupwise-loss-gla")
