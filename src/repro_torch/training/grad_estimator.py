"""Confidence-bounded gradient accumulation — PF-OLA's estimator applied to
the microbatch loop.

Port of ``repro/training/grad_estimator.py`` (and of the demo
``examples/adaptive_batch.py`` as :func:`main`).  A gradient over a global
batch is an associative-decomposable aggregate of per-microbatch
contributions — a GLA.  Treating the microbatch stream as the scan and the
per-microbatch loss as ``func(d)``, the paper's Eq. (2)/(4) estimator gives
an anytime confidence interval on the step's mean loss, with D the step's
microbatches and S those processed so far.  Once the relative width drops
below a target, the step fires early (an adaptive effective batch size).

    python -m repro_torch.training.grad_estimator               # on the card
    python -m repro_torch.training.grad_estimator --device cpu
"""
from __future__ import annotations

import argparse
from typing import Callable

import torch

from repro_torch import estimators as E
from repro_torch._device import resolve_device
from repro_torch.uda import tree_leaves, tree_map

_F32 = torch.float32


def ci_relative_width(sum_, sumsq, n, n_total, confidence=0.95):
    """Relative CI width of the mean estimate after n of n_total microbatches."""
    sum_ = torch.as_tensor(sum_, dtype=_F32)
    sumsq = torch.as_tensor(sumsq, dtype=_F32)
    n = torch.as_tensor(n, dtype=_F32)
    n_total = torch.as_tensor(n_total, dtype=_F32)
    est = E.horvitz_estimate(sum_, n, n_total)
    var = E.variance_estimate(sum_, sumsq, n, n_total)
    lo, hi = E.normal_bounds(est, var, confidence)
    return (hi - lo) / torch.clamp(torch.abs(est), min=1e-9)


def accumulate_until_confident(
    grad_fn: Callable,            # (params, microbatch) -> (loss, grads)
    params,
    microbatches,                 # dict of tensors with leading axis M
    *,
    target_rel_width: float = 0.05,
    min_micro: int = 2,
    confidence: float = 0.95,
):
    """Accumulate microbatch grads until the loss-mean CI is tight.

    Returns (grads_mean, n_used, history) — grads averaged over the n_used
    microbatches actually consumed, summed in the grads' dtype in
    microbatch order.  The estimator state is the paper's (sum, sumSq,
    count); n_total = M (sampling without replacement from the step's
    population)."""
    M = tree_leaves(microbatches)[0].shape[0]
    g_acc = None
    s = sq = 0.0
    history = []
    n_used = M
    for i in range(M):
        mb = tree_map(lambda x, i=i: x[i], microbatches)
        loss, g = grad_fn(params, mb)
        loss = float(loss)
        g_acc = g if g_acc is None else tree_map(torch.add, g_acc, g)
        s += loss
        sq += loss * loss
        if i + 1 >= min_micro:
            w = float(ci_relative_width(s, sq, i + 1, M, confidence))
        else:
            w = float("inf")
        history.append({"n": i + 1, "loss": loss, "rel_width": w})
        if w <= target_rel_width:
            n_used = i + 1
            break
    grads = tree_map(lambda g: g / n_used, g_acc)
    return grads, n_used, history


SEQ, MICRO, MB = 32, 16, 4


def main(argv=None):
    """``examples/adaptive_batch.py`` on the port: the smoke smollm-135m,
    8 steps of MICRO microbatches of MB x SEQ random tokens, each step
    firing once the loss mean's relative CI width is at most 0.08."""
    from repro_torch.configs import get_config
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as TS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("smollm_135m").smoke()
    model, opt = TS.init_train_state(cfg, seed=0, dtype=torch.float32, device=dev)

    def grad_fn(m, mb):
        (loss, _), g = TS.value_and_grad(m, cfg, mb)
        return loss, g

    used = []
    for step in range(args.steps):
        gen = torch.Generator(device=dev).manual_seed(step)
        toks = torch.randint(0, cfg.vocab_size, (MICRO * MB, SEQ), generator=gen, device=dev)
        micro = {"tokens": toks.reshape(MICRO, MB, SEQ)}
        grads, n_used, hist = accumulate_until_confident(grad_fn, model, micro,
                                                         target_rel_width=0.08)
        _, opt = O.opt_update(grads, opt, model.params, cfg.optimizer, lr=3e-3)
        last = hist[-1]
        print(f"step {step}: used {n_used}/{MICRO} microbatches "
              f"(rel CI width {last['rel_width']:.3f}), loss {last['loss']:.4f}")
        used.append(n_used)
    return used


if __name__ == "__main__":
    main()
