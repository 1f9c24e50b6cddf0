"""Port parity for interactive sessions: ``repro_torch.Session`` stops at the
same round as the reference ``Session`` under the same stopping rule, picks
the same per-round path (``kernel_fused``, ``kernel_group``,
``kernel_bundle``, ``kernel_scalar``), and its incremental discipline
reproduces the whole-scan program: bitwise on every path but
``kernel_scalar``, whose per-round K4 deltas re-associate against the
whole-scan cumsum (rtol=1e-5, as the reference calls the two
interchangeable).

The fixture picks ε between two consecutive rounds' reference widths, so
that the stopping round's bounds clear ε with margin (the port's half-widths
agree with the reference's to rtol=1e-3, see test_torch_engine.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as T
from repro.core import gla as RG
from repro.core import randomize as RR
from repro.core import session as RS
from repro.core.spec import QuerySpec as RQuerySpec
from repro.core.uda import Estimate as REstimate
from repro.data import tpch as RT
from repro_torch import convert
from repro_torch.data import tpch as TT

P, C, L = 4, 8, 256
ROWS = P * C * L
ROUNDS = 8
MARGIN = 1.05  # the widths on either side of ε differ from it by >= 5%


@pytest.fixture(scope="module")
def shards():
    raw = RT.generate_lineitem(ROWS, seed=5)
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in raw.items()},
                                jax.random.key(8), P)
    ref = RR.pack_partitions(parts, chunk_len=L)
    return ref, convert.shards_from_reference(
        {k: np.asarray(v) for k, v in ref.items()}, device="cpu")


def _dense_cond_ref(c):
    return (c["shipdate"] < 1460).astype(jnp.float32)


def _dense_cond(c):
    return (c["shipdate"] < 1460).to(torch.float32)


def _pair(name):
    d = float(ROWS)
    if name == "q6-dense":
        return (RG.make_sum_gla(RT.q6_func, _dense_cond_ref, d_total=d),
                T.make_sum_gla(TT.q6_func, _dense_cond, d_total=d))
    return (RG.make_groupby_gla(RT.q1_func, _dense_cond_ref, RT.q1_group_small,
                                num_groups=4, d_total=d, num_aggs=4),
            T.make_groupby_gla(TT.q1_func, _dense_cond, TT.q1_group_small,
                               num_groups=4, d_total=d, num_aggs=4))


def _rel_widths(est):
    half = (np.asarray(est.upper, np.float64) - np.asarray(est.lower, np.float64)) / 2
    mid = np.abs(np.asarray(est.estimate, np.float64))
    rel = np.where(half == 0, 0.0, half / np.maximum(mid, 1e-300))
    return rel.reshape(rel.shape[0], -1).max(axis=1)  # per round


def _epsilon(widths):
    """ε between rounds k-1 and k (0-based k >= 1) with margin on both sides."""
    for k in range(1, len(widths)):
        prev = widths[:k].min()
        if np.isfinite(prev) and prev > widths[k] * MARGIN**2:
            return float(np.sqrt(prev * widths[k])), k + 1
    raise AssertionError(f"no round boundary with margin in {widths}")


@pytest.mark.parametrize("emit", ["chunk", "kernel"])
@pytest.mark.parametrize("query", ["q6-dense", "q1-small"])
def test_rel_width_stops_at_the_reference_round(shards, query, emit):
    ref_shards, t_shards = shards
    rgla, tgla = _pair(query)
    full = RS.Session(RQuerySpec(rgla, rounds=ROUNDS), ref_shards).run()
    eps, expect = _epsilon(_rel_widths(full.estimates))

    rs = RS.Session(RQuerySpec(rgla, rounds=ROUNDS, stop=RS.rel_width(eps)),
                    ref_shards)
    rs.run()
    ts = T.Session(T.QuerySpec(tgla, rounds=ROUNDS, emit=emit,
                               stop=T.rel_width(eps)), t_shards, device="cpu")
    res = ts.run()
    assert rs.steps_taken == expect
    assert ts.steps_taken == rs.steps_taken and ts.converged
    assert res.estimates.estimate.shape[0] == ts.steps_taken
    np.testing.assert_array_equal(res.snapshots.scanned.numpy(),
                                  np.asarray(rs.result().snapshots.scanned))


@pytest.mark.parametrize("emit", ["chunk", "kernel"])
@pytest.mark.parametrize("query", ["q6-dense", "q1-small"])
def test_incremental_steps_equal_the_whole_scan(shards, query, emit):
    """Round by round the session keeps the whole-scan program's chunk
    order, so its states and finals are bitwise-equal to ``run()``'s."""
    _, t_shards = shards
    _, tgla = _pair(query)
    spec = T.QuerySpec(tgla, rounds=ROUNDS, emit=emit)
    whole = T.Session(spec, t_shards, device="cpu").run()
    sess = T.Session(spec, t_shards, device="cpu")
    progs = [sess.step() for _ in range(ROUNDS)]
    assert sess.done and not sess.converged
    assert [p.round for p in progs] == list(range(1, ROUNDS + 1))
    assert progs[-1].scanned == ROWS
    res = sess.result()
    assert torch.equal(res.final, whole.final)
    for a, b in zip(res.snapshots, whole.snapshots):
        assert torch.equal(a, b)
    assert torch.equal(res.estimates.upper, whole.estimates.upper)


def _legacy(pair):
    """The same GLAs without their fused contract: the legacy kernel paths."""
    return tuple(g.with_(fused=None) for g in pair)


def _path_cases():
    q6, q1 = _pair("q6-dense"), _pair("q1-small")
    return {
        "kernel_fused": q6,
        "kernel_scalar": _legacy(q6),
        "kernel_group": _legacy(q1),
        "kernel_fused/bundle": (RG.GLABundle([q6[0], q1[0]]),
                                T.GLABundle([q6[1], q1[1]])),
        "kernel_bundle": (RG.GLABundle([q6[0], _legacy(q1)[0]]),
                          T.GLABundle([q6[1], _legacy(q1)[1]])),
    }


@pytest.mark.parametrize("case", ["kernel_fused", "kernel_scalar", "kernel_group",
                                  "kernel_fused/bundle", "kernel_bundle"])
def test_session_path_agrees_with_reference(shards, case):
    ref_shards, t_shards = shards
    rgla, tgla = _path_cases()[case]
    r = RS.Session(RQuerySpec(rgla, rounds=ROUNDS, emit="kernel"), ref_shards)._path
    t = T.Session(T.QuerySpec(tgla, rounds=ROUNDS, emit="kernel"), t_shards,
                  device="cpu")._path
    assert t == r == case.split("/")[0]


@pytest.mark.parametrize("case", ["kernel_group", "kernel_bundle", "kernel_scalar"])
def test_legacy_steps_equal_the_whole_scan(shards, case):
    """Delta-style steps: the first round's state is its delta and later
    rounds add onto it, as the whole scan folds its per-round deltas."""
    _, t_shards = shards
    tgla = _path_cases()[case][1]
    spec = T.QuerySpec(tgla, rounds=ROUNDS, emit="kernel")
    whole = T.Session(spec, t_shards, device="cpu").run()
    sess = T.Session(spec, t_shards, device="cpu")
    while not sess.done:
        sess.step()
    res = sess.result()
    pairs = list(zip(jax.tree.leaves(tuple(res.snapshots)),
                     jax.tree.leaves(tuple(whole.snapshots))))
    pairs += list(zip(jax.tree.leaves(res.final), jax.tree.leaves(whole.final)))
    assert pairs
    for a, b in pairs:
        if case == "kernel_scalar":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("query", ["q6-dense", "q1-small"])
def test_legacy_paths_stop_at_the_reference_round(shards, query):
    """K4 (scalar) and K3 (group) sessions under rel_width stop where the
    reference's legacy sessions stop."""
    ref_shards, t_shards = shards
    rgla, tgla = _legacy(_pair(query))
    full = RS.Session(RQuerySpec(rgla, rounds=ROUNDS), ref_shards).run()
    eps, expect = _epsilon(_rel_widths(full.estimates))
    rs = RS.Session(RQuerySpec(rgla, rounds=ROUNDS, emit="kernel",
                               stop=RS.rel_width(eps)), ref_shards)
    rs.run()
    ts = T.Session(T.QuerySpec(tgla, rounds=ROUNDS, emit="kernel",
                               stop=T.rel_width(eps)), t_shards, device="cpu")
    ts.run()
    assert ts.steps_taken == rs.steps_taken == expect and ts.converged


def _progress(cls, est_cls, rnd, est):
    return cls(round=rnd, rounds_total=8, estimates=est_cls(*est) if est else None,
               scanned=1000.0 * rnd, d_total=8000.0, elapsed_s=0.5 * rnd)


@pytest.mark.parametrize("rnd", [1, 2, 3])
@pytest.mark.parametrize("est", [
    None,
    ([10.0, 20.0], [9.0, 19.5], [11.0, 20.5]),
    ([10.0, 0.0], [9.9, 0.0], [10.1, 0.0]),
    ([10.0, 5.0], [-np.inf, 4.0], [np.inf, 6.0]),
])
def test_stopping_rules_decide_as_the_reference(rnd, est):
    rules = [
        (RS.rel_width(0.05), T.rel_width(0.05)),
        (RS.rel_width(0.05, min_rounds=2), T.rel_width(0.05, min_rounds=2)),
        (RS.abs_width(0.6), T.abs_width(0.6)),
        (RS.budget(max_rounds=2), T.budget(max_rounds=2)),
        (RS.budget(max_tuples=2500), T.budget(max_tuples=2500)),
        (RS.budget(max_seconds=1.0), T.budget(max_seconds=1.0)),
        (RS.any_of(RS.abs_width(0.6), RS.budget(max_rounds=3)),
         T.any_of(T.abs_width(0.6), T.budget(max_rounds=3))),
        (RS.all_of(RS.rel_width(0.05), RS.budget(max_rounds=2)),
         T.all_of(T.rel_width(0.05), T.budget(max_rounds=2))),
    ]
    r_est = None if est is None else tuple(jnp.asarray(x, jnp.float32) for x in est)
    t_est = None if est is None else tuple(torch.tensor(x) for x in est)
    r_prog = _progress(RS.RoundProgress, REstimate, rnd, r_est)
    t_prog = _progress(T.RoundProgress, T.Estimate, rnd, t_est)
    for r_rule, t_rule in rules:
        assert t_rule(t_prog) == r_rule(r_prog)


def test_session_contract_errors(shards):
    _, t_shards = shards
    _, tgla = _pair("q6-dense")
    with pytest.raises(ValueError, match="incrementally"):
        T.Session(T.QuerySpec(tgla, sync=True, stop=T.rel_width(0.1)), t_shards,
                  device="cpu")
    sess = T.Session(T.QuerySpec(tgla, rounds=2), t_shards, device="cpu")
    with pytest.raises(RuntimeError, match="no rounds"):
        sess.result()
    sess.run()
    with pytest.raises(RuntimeError, match="completion"):
        sess.step()
