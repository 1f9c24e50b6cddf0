"""The online eval over a real model forward: the paper's query (1) with
``func(d) = loss(params, d)`` (``examples/online_eval.py``) on the port,
against the reference on the same packed corpus.

A smoke smollm-135m with float32 weights from the reference's
``init_params``, carried across by ``convert.lm_params_from_reference``;
a corpus of 2,048 examples of 16 tokens (``token_batches``' numpy draws),
one column a position, randomized and packed by the reference and handed
to both packages.  The reference evaluates its loss per chunk inside its
scan; the port's closure gets whole ``[P, C, L]`` projections (K2's and K1's
pre-pass) and runs the model over bounded blocks of examples.

Tolerances, as ``test_torch_metrics.py``: counters exact; sums, estimates
and bounds rtol 1e-5 with atol 1e-5·max|ref|; the per-example losses
within 1e-5 relative (float32 forwards in two frameworks).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as T
from repro.configs import get_config as rget
from repro.core import engine as REN
from repro.core import metrics as RM
from repro.core import randomize as RR
from repro.core import session as RS
from repro.core.spec import QuerySpec as RQuerySpec
from repro.data import tokens as RTOK
from repro.models import spec as RSPEC
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch import metrics as TM
from repro_torch.configs import get_config as tget

N, SEQ, P, L, ROUNDS = 2_048, 16, 4, 64, 8
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = rget("smollm_135m").smoke()
    params = RSPEC.init_params(RT.param_specs(cfg, dtype=jnp.float32), jax.random.key(0))
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                             tget("smollm_135m").smoke(), device="cpu")
    toks = np.asarray(next(RTOK.token_batches(cfg, N, SEQ, seed=7))[0]["tokens"])
    cols = {f"t{j}": jnp.asarray(toks[:, j]) for j in range(SEQ)}
    parts = RR.randomize_global(cols, jax.random.key(1), P)
    ref = {k: np.asarray(v) for k, v in RR.pack_partitions(parts, chunk_len=L).items()}
    return cfg, params, model, toks, ref, convert.shards_from_reference(ref, device="cpu")


def _ref_loss(params, cfg):
    """``examples/online_eval.py``'s ``loss_per_example``."""
    def loss_per_example(chunk):
        tt = jnp.stack([chunk[f"t{j}"] for j in range(SEQ)], axis=1)
        x, _, _ = RT.forward(params, cfg, {"tokens": tt})
        tgt = jnp.pad(tt[:, 1:], ((0, 0), (0, 1)))
        logits = (x @ params["embed"].T).astype(jnp.float32)  # tied embeddings
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, tgt[..., None], axis=-1)[..., 0]
        return jnp.mean((lse - gold)[:, :-1], axis=1)

    return loss_per_example


def _close(got, want, what):
    a = torch.as_tensor(got).numpy().astype(np.float64)
    b = np.asarray(want, np.float64)
    assert a.shape == b.shape, what
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin), what
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL,
                               atol=RTOL * np.abs(b[fin]).max(initial=0.0), err_msg=what)


def test_example_loss_matches_the_reference_and_its_blocking():
    cfg, params, model, toks, _, _ = _setup()
    want = np.asarray(_ref_loss(params, cfg)({f"t{j}": jnp.asarray(toks[:256, j])
                                             for j in range(SEQ)}))
    got = model.example_nll(torch.from_numpy(toks[:256].copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    # blocks of 7 examples, logits of 50 positions at a time: the same losses
    small = model.example_nll(torch.from_numpy(toks[:256].copy()), block=7, rows=50)
    np.testing.assert_allclose(small.numpy(), got.numpy(), rtol=1e-6)
    assert np.all(want > 0) and np.isfinite(want).all()


def test_loss_closure_flattens_the_leading_axes():
    """The pre-pass hands the closure [P, C, L] columns (K2) or a
    round-slice (K1): the closure's losses keep that shape, row for row."""
    _, _, model, _, _, shards = _setup()
    fn = TM.lm_loss_per_example(model, SEQ)
    sl = {k: v[:, 2:4] for k, v in shards.items()}
    got = fn(sl)
    assert got.shape == (P, 2, L) and got.dtype == torch.float32
    flat = model.example_nll(torch.stack([sl[f"t{j}"] for j in range(SEQ)], -1).reshape(-1, SEQ))
    assert torch.equal(got.reshape(-1), flat)


@pytest.mark.parametrize("emit", ["kernel", "chunk"])
def test_run_query_over_the_model_matches_the_reference(emit):
    """``run_query`` over the loss GLA (K2's plain version on "kernel")
    against the reference's per-chunk scan, and the mean ± half-width."""
    cfg, params, model, toks, ref_shards, shards = _setup()
    got = T.run_query(T.QuerySpec(TM.make_loss_gla(TM.lm_loss_per_example(model, SEQ),
                                                   d_total=float(N)),
                                  rounds=ROUNDS, emit=emit), shards, device="cpu")
    want = REN.run_query(RQuerySpec(RM.make_loss_gla(_ref_loss(params, cfg), d_total=float(N)),
                                    rounds=ROUNDS, emit="chunk"), ref_shards)
    for f in ("scanned", "matched"):
        np.testing.assert_array_equal(getattr(got.snapshots, f).numpy(),
                                      np.asarray(getattr(want.snapshots, f)))
    for f in ("sum", "sumsq"):
        _close(getattr(got.snapshots, f), getattr(want.snapshots, f), f)
    _close(got.final, want.final, "final")
    for f in ("estimate", "lower", "upper"):
        _close(getattr(got.estimates, f), getattr(want.estimates, f), f)
    mean, lo, hi = TM.mean_with_bounds(got.estimates)
    for a, b in zip((mean, lo, hi), RM.mean_with_bounds(want.estimates)):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    truth = float(np.asarray(_ref_loss(params, cfg)({f"t{j}": jnp.asarray(toks[:, j])
                                                     for j in range(SEQ)}), np.float64).mean())
    assert abs(mean[-1] - truth) <= 1e-5 * truth
    assert lo[0] <= truth <= hi[0]


def test_session_over_the_model_stops_where_the_reference_does():
    """A ``Session`` under ``rel_width``: ε between two rounds' reference
    widths, so both stop at the same round (K1 scalar's plain version on
    "kernel"), with the same counters and estimates."""
    cfg, params, model, _, ref_shards, shards = _setup()
    rgla = RM.make_loss_gla(_ref_loss(params, cfg), d_total=float(N))
    full = REN.run_query(RQuerySpec(rgla, rounds=ROUNDS, emit="chunk"), ref_shards)
    est = full.estimates
    half = (np.asarray(est.upper, np.float64) - np.asarray(est.lower, np.float64)) / 2
    widths = (half / np.abs(np.asarray(est.estimate, np.float64))).max(axis=1)  # per round
    k = 3  # stop after round k: ε between rounds k-1 and k
    assert widths[k - 2] > widths[k - 1] * 1.1
    eps = float(np.sqrt(widths[k - 2] * widths[k - 1]))
    rs = RS.Session(RQuerySpec(rgla, rounds=ROUNDS, stop=RS.rel_width(eps)), ref_shards)
    rres = rs.run()
    ts = T.Session(T.QuerySpec(TM.make_loss_gla(TM.lm_loss_per_example(model, SEQ),
                                                d_total=float(N)),
                               rounds=ROUNDS, emit="kernel", stop=T.rel_width(eps)),
                   shards, device="cpu")
    tres = ts.run()
    assert rs.steps_taken == ts.steps_taken == k and ts.converged
    np.testing.assert_array_equal(tres.snapshots.scanned.numpy(), np.asarray(rres.snapshots.scanned))
    for f in ("estimate", "lower", "upper"):
        _close(getattr(tres.estimates, f), getattr(rres.estimates, f), f)
