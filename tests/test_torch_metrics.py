"""The online-eval bridge in the port (``repro_torch.metrics``): a per-example
loss as the func of a SUM/COUNT GLA, against the reference's
``repro.core.metrics`` on the same shards (built with the reference's
randomizer and packer, converted with ``repro_torch.convert``).

The port of ``tests/test_system.py::test_online_eval_bridge_early_stop``, plus
parity.  Tolerances: counters exact; sums, estimates and bounds rtol 1e-5
with atol 1e-5·max|ref| (the summation order differs); the mean and its
bounds from ``mean_with_bounds`` rtol 1e-5; the reference test's own checks
(mean within 1e-3 of the truth) as it states them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as T
from repro.core import engine as REN
from repro.core import metrics as RM
from repro.core import randomize as RR
from repro.core.spec import QuerySpec as RQuerySpec
from repro_torch import convert
from repro_torch import metrics as TM

N = 8_192
ROUNDS = 8
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.default_rng(3)
    scores = rng.normal(3.0, 0.3, N).astype(np.float32)
    cols = {"score": jnp.asarray(scores),
            "domain": jnp.asarray(np.arange(N, dtype=np.int32) % 3)}
    parts = RR.randomize_global(cols, jax.random.key(0), 4)
    ref = {k: np.asarray(v) for k, v in RR.pack_partitions(parts, chunk_len=128).items()}
    return scores, ref, convert.shards_from_reference(ref, device="cpu")


def _close(got, want, what):
    a = torch.as_tensor(got).numpy().astype(np.float64)
    b = np.asarray(want, np.float64)
    assert a.shape == b.shape, what
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin), what
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL,
                               atol=RTOL * np.abs(b[fin]).max(initial=0.0), err_msg=what)


def _port(gla, emit="chunk"):
    return T.run_query(T.QuerySpec(gla, rounds=ROUNDS, emit=emit), _data()[2], device="cpu")


def test_online_eval_bridge_early_stop():
    """Loss GLA over a toy scoring function: bounds are valid and tighten."""
    scores = _data()[0]
    g = TM.make_loss_gla(lambda c: c["score"], d_total=float(N))
    res = _port(g)
    mean, lo, hi = TM.mean_with_bounds(res.estimates)
    true_mean = scores.mean()
    assert abs(mean[-1] - true_mean) < 1e-3
    # early rounds bracket the truth and tighten
    assert lo[0] <= true_mean <= hi[0]
    assert (hi[-1] - lo[-1]) < (hi[0] - lo[0])


@pytest.mark.parametrize("emit", ["chunk", "round", "kernel"])
def test_loss_gla_matches_reference(emit):
    """The port's loss GLA on every path (K2 and K1 scalar's plain versions
    on ``"kernel"``) against the reference's scan, and its mean bounds."""
    _, ref_shards, _ = _data()
    got = _port(TM.make_loss_gla(lambda c: c["score"], d_total=float(N)), emit)
    want = REN.run_query(RQuerySpec(
        RM.make_loss_gla(lambda c: c["score"], d_total=float(N)), rounds=ROUNDS,
        emit="chunk"), ref_shards)
    for f in ("scanned", "matched"):
        np.testing.assert_array_equal(getattr(got.snapshots, f).numpy(),
                                      np.asarray(getattr(want.snapshots, f)))
    for f in ("sum", "sumsq"):
        _close(getattr(got.snapshots, f), getattr(want.snapshots, f), f)
    _close(got.final, want.final, "final")
    for f in ("estimate", "lower", "upper"):
        _close(getattr(got.estimates, f), getattr(want.estimates, f), f)
    for a, b in zip(TM.mean_with_bounds(got.estimates), RM.mean_with_bounds(want.estimates)):
        np.testing.assert_allclose(a, b, rtol=RTOL)


def test_loss_gla_with_a_selection_and_session_stop():
    """A predicate-selected subset and a stopping rule: the session stops
    early with the mean within its bounds of the subset's truth."""
    scores, _, shards = _data()
    g = TM.make_loss_gla(lambda c: c["score"], d_total=float(N),
                         cond=lambda c: (c["domain"] == 1).to(torch.float32))
    sess = T.Session(T.QuerySpec(g, rounds=ROUNDS, emit="kernel",
                                 stop=T.rel_width(0.05)), shards, device="cpu")
    res = sess.run()
    assert sess.steps_taken < ROUNDS
    mean, lo, hi = TM.mean_with_bounds(res.estimates)
    truth = scores[np.arange(N) % 3 == 1].mean()
    assert lo[-1] <= truth <= hi[-1]
    assert g.name == "loss-gla" and g.fused is not None and g.fused.num_aggs == 2


def test_groupwise_loss_gla_matches_reference():
    _, ref_shards, shards = _data()
    got = _port(TM.make_groupwise_loss_gla(lambda c: c["score"], lambda c: c["domain"],
                                           num_groups=3, d_total=float(N)), "kernel")
    want = REN.run_query(RQuerySpec(RM.make_groupwise_loss_gla(
        lambda c: c["score"], lambda c: c["domain"], num_groups=3, d_total=float(N)),
        rounds=ROUNDS, emit="chunk"), ref_shards)
    _close(got.final, want.final, "final")
    np.testing.assert_array_equal(got.snapshots.matched.numpy(),
                                  np.asarray(want.snapshots.matched))
    for f in ("estimate", "lower", "upper"):
        _close(getattr(got.estimates, f), getattr(want.estimates, f), f)
    scores = _data()[0]
    for gi in range(3):
        sel = scores[np.arange(N) % 3 == gi]
        np.testing.assert_allclose(got.final[gi].numpy(), [sel.astype(np.float64).sum(), len(sel)],
                                   rtol=1e-5)


def test_loss_gla_takes_float32_only():
    TM.make_loss_gla(lambda c: c["score"], d_total=1.0, dtype=torch.float32)
    with pytest.raises(ValueError, match="float32"):
        TM.make_loss_gla(lambda c: c["score"], d_total=1.0, dtype=torch.float64)
