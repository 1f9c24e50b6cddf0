"""Port parity for multi-query bundles (paper §3: any number of estimators
over one scan): ``GLABundle`` and ``run_queries`` against the reference's
on the same packed shards.

Within the port a member of a bundle equals its solo run bit for bit on
the scan paths, on the fused kernel path (K1 bundle mode) and, for group
members, on the legacy K3 path; against the reference the bundle results
hold within the tolerances of test_torch_engine.py: counters exact; f32
finals, snapshot sums and estimates rtol=1e-5 with atol=1e-5·max|ref|;
half-widths rtol=1e-3.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as T
from repro.core import engine as REN
from repro.core import gla as RG
from repro.core import randomize as RR
from repro.core import session as RS
from repro.core.spec import QuerySpec as RQuerySpec
from repro.data import tpch as RT
from repro.kernels import fused_agg as RFK
from repro_torch import convert
from repro_torch.data import tpch as TT

P, C, L = 4, 8, 256
ROWS = P * C * L - 100
ROUNDS = 4
BIG = RFK.PROBE_VMEM_BUDGET_BYTES // 4 + 1
RTOL = 1e-5
HALF_RTOL = 1e-3
D = float(ROWS)


@pytest.fixture(scope="module")
def dims():
    return {"small": RT.orders_table(ROWS // 4, seed=41),
            "big": RT.orders_table(BIG, seed=42)}


@pytest.fixture(scope="module")
def ref_shards():
    cols = RT.generate_lineitem(ROWS, seed=17)
    cols["orderkey"] = RT.generate_orders_fk(ROWS, seed=17)
    cols["orderkey_big"] = RT.generate_orders_fk(ROWS, num_orders=BIG, seed=18)
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in cols.items()},
                                jax.random.key(6), P)
    return RR.pack_partitions(parts, chunk_len=L, min_chunks=C)


@pytest.fixture(scope="module")
def shards(ref_shards):
    return convert.shards_from_reference(
        {k: np.asarray(v) for k, v in ref_shards.items()}, device="cpu")


def _dense_ref(c):
    return (c["shipdate"] < 1460).astype(jnp.float32)


def _dense(c):
    return (c["shipdate"] < 1460).to(torch.float32)


def _pair(name, dims=None):
    """(reference GLA, port GLA) by name."""
    if name == "q6":
        win = RT.Q6_LOW_WINDOW
        return (RG.make_sum_gla(RT.q6_func, RT.q6_cond(win), d_total=D),
                T.make_sum_gla(TT.q6_func, TT.q6_cond(win), d_total=D))
    if name == "q6-dense":
        return (RG.make_sum_gla(RT.q6_func, _dense_ref, d_total=D),
                T.make_sum_gla(TT.q6_func, _dense, d_total=D))
    if name == "q1-dense":
        return (RG.make_groupby_gla(RT.q1_func, _dense_ref, RT.q1_group_small,
                                    num_groups=4, d_total=D, num_aggs=4),
                T.make_groupby_gla(TT.q1_func, _dense, TT.q1_group_small,
                                   num_groups=4, d_total=D, num_aggs=4))
    if name == "q1-small":
        return (RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_small,
                                    num_groups=4, d_total=D, num_aggs=4),
                T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small,
                                   num_groups=4, d_total=D, num_aggs=4))
    if name == "q1-bucketed":
        kw = dict(num_groups=1000, bucket_bits=7, d_total=D, num_aggs=4)
        return (RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_large, **kw),
                T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_large, **kw))
    size = name.split("-")[1]  # "q3-small" / "q3-big"
    col = "orderkey" if size == "small" else "orderkey_big"
    seg, valid = dims[size]
    kw = dict(num_groups=RT.NUM_SEGMENTS, d_total=D)
    return (RG.make_join_groupby_gla(RT.q6_func, RT.q1_cond, lambda c: c[col],
                                     seg, valid, **kw),
            T.make_join_groupby_gla(TT.q6_func, TT.q1_cond, lambda c: c[col],
                                    seg, valid, device="cpu", **kw))


_PAIRS = {}


def _glas(names, dims):
    """Cached pairs, so that the same GLA objects recur (bundles memoize on
    member identity)."""
    out = []
    for n in names:
        if n not in _PAIRS:
            _PAIRS[n] = _pair(n, dims)
        out.append(_PAIRS[n])
    return [r for r, _ in out], [t for _, t in out]


FUSED = ["q6", "q1-small", "q1-bucketed", "q3-small"]
LEGACY = ["q6", "q1-small", "q3-big"]


def _close(got, want, rtol, what):
    a = got.detach().numpy().astype(np.float64)
    b = np.asarray(want, np.float64)
    assert a.shape == b.shape, what
    assert not np.isnan(a).any(), what
    assert np.array_equal(np.isinf(a), np.isinf(b)), what
    fin = np.isfinite(b)
    atol = rtol * max(np.abs(b[fin]).max(initial=0.0), 0.0)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=atol, err_msg=what)


def _assert_result(got, want):
    _close(got.final, want.final, RTOL, "final")
    for f in ("scanned", "matched"):
        np.testing.assert_array_equal(getattr(got.snapshots, f).numpy(),
                                      np.asarray(getattr(want.snapshots, f)), err_msg=f)
    for f in ("sum", "sumsq"):
        _close(getattr(got.snapshots, f), getattr(want.snapshots, f), RTOL, f)
    ge, we = got.estimates, want.estimates
    _close(ge.estimate, we.estimate, RTOL, "estimate")
    _close((ge.upper - ge.lower) / 2,
           (np.asarray(we.upper) - np.asarray(we.lower)) / 2, HALF_RTOL, "half-width")


def _bitwise(a, b):
    """Two results of the port, leaf by leaf."""
    assert torch.equal(a.final, b.final)
    for x, y in zip(a.snapshots, b.snapshots):
        assert torch.equal(x, y)
    for f in ("estimate", "lower", "upper"):
        assert torch.equal(getattr(a.estimates, f), getattr(b.estimates, f))


def test_bundle_is_a_memoized_gla(dims):
    _, (q6, q1, q3) = _glas(["q6", "q1-small", "q3-small"], dims)
    b = T.GLABundle([q6, q1, q3])
    assert isinstance(b, T.GLA) and b.members == (q6, q1, q3)
    assert T.GLABundle((q6, q1, q3)) is b
    assert b.name == f"bundle[{q6.name}+{q1.name}+{q3.name}]"
    assert b.merge_is_additive and b.kernel_cols is None and b.fused is None
    st = b.init("cpu")
    assert isinstance(st, tuple) and len(st) == 3 and st[1].sum.shape == (4, 4)
    none = T.make_sum_gla(TT.q6_func, _dense, d_total=D, estimator="none")
    assert T.GLABundle([none]).estimate is None
    with pytest.raises(ValueError, match="at least one"):
        T.GLABundle([])
    with pytest.raises(ValueError, match="bundles"):
        T.GLABundle([b, q6])


@pytest.mark.parametrize("emit", ["round", "chunk"])
def test_run_queries_members_equal_solo_runs(dims, shards, emit):
    """One pass for three queries: each member bitwise-equal to its solo
    run_query on the scan paths."""
    _, glas = _glas(["q6", "q1-small", "q3-small"], dims)
    res = T.run_queries(T.QuerySpec(glas, rounds=ROUNDS, emit=emit), shards,
                        device="cpu")
    assert len(res) == 3
    for g, r in zip(glas, res):
        _bitwise(r, T.run_query(T.QuerySpec(g, rounds=ROUNDS, emit=emit), shards,
                                device="cpu"))


def test_run_queries_defaults_to_round_emission(dims, shards):
    _, glas = _glas(["q6", "q1-small"], dims)
    spec = T.QuerySpec(glas, rounds=ROUNDS)
    assert spec.is_multi and spec.resolved_emit() == "round"
    a = T.run_queries(spec, shards, device="cpu")
    b = T.run_queries(spec.with_(emit="round"), shards, device="cpu")
    for x, y in zip(a, b):
        _bitwise(x, y)


_RQ = {}


@pytest.mark.parametrize("which", ["fused", "legacy"])
def test_run_queries_kernel_matches_reference(dims, ref_shards, shards, which):
    """emit="kernel": all-fused bundles (K1 bundle mode) and bundles with a
    join past the probe budget (K3) against the reference's run_queries."""
    names = FUSED if which == "fused" else LEGACY
    rglas, tglas = _glas(names, dims)
    if which not in _RQ:
        _RQ[which] = REN.run_queries(RQuerySpec(rglas, rounds=ROUNDS, emit="kernel"),
                                     ref_shards)
    got = T.run_queries(T.QuerySpec(tglas, rounds=ROUNDS, emit="kernel"), shards,
                        device="cpu")
    for g, w in zip(got, _RQ[which]):
        _assert_result(g, w)
    r_path = RS.Session(RQuerySpec(RG.GLABundle(rglas), rounds=ROUNDS, emit="kernel"),
                        ref_shards)._path
    t_path = T.Session(T.QuerySpec(T.GLABundle(tglas), rounds=ROUNDS, emit="kernel"),
                       shards, device="cpu")._path
    assert t_path == r_path == ("kernel_fused" if which == "fused" else "kernel_bundle")


def test_fused_bundle_members_equal_solo_kernel_runs(dims, shards):
    """K1 bundle mode: every member, scalar included, bitwise-equal to its
    own emit="kernel" run."""
    _, glas = _glas(FUSED, dims)
    res = T.run_queries(T.QuerySpec(glas, rounds=ROUNDS, emit="kernel"), shards,
                        device="cpu")
    for g, r in zip(glas, res):
        _bitwise(r, T.run_query(T.QuerySpec(g, rounds=ROUNDS, emit="kernel"),
                                shards, device="cpu"))


def test_legacy_bundle_group_members_equal_solo_k3_runs(dims, shards):
    """The K3 bundle path: each group member's rows are whole chunks of its
    own, so it equals its solo K3 run bit for bit; the scalar member, a
    one-group table here, stays within tolerance of its solo K4 run."""
    _, (q6, q1, q3) = _glas(LEGACY, dims)
    members = [q6.with_(fused=None), q1.with_(fused=None), q3]
    res = T.run_queries(T.QuerySpec(members, rounds=ROUNDS, emit="kernel"), shards,
                        device="cpu")
    solo = [T.run_query(T.QuerySpec(g, rounds=ROUNDS, emit="kernel"), shards,
                        device="cpu") for g in members]
    _bitwise(res[1], solo[1])
    _bitwise(res[2], solo[2])
    _close(res[0].final, solo[0].final.numpy(), RTOL, "scalar member")
    _close(res[0].snapshots.sum, solo[0].snapshots.sum.numpy(), RTOL, "scalar sums")


def test_scan_only_members_are_refused(dims, ref_shards, shards):
    """A member with neither contract cannot ride one kernel launch; the
    port refuses it with the reference's words."""
    (rq6, rq1), (q6, q1) = _glas(["q6", "q1-small"], dims)
    msgs = []
    for run, spec, data in (
            (REN.run_queries, RQuerySpec([rq6, rq1.with_(fused=None, kernel_cols=None,
                                                         kernel_num_groups=None)],
                                         rounds=ROUNDS, emit="kernel"), ref_shards),
            (lambda s, d: T.run_queries(s, d, device="cpu"),
             T.QuerySpec([q6, q1.with_(fused=None, kernel_cols=None,
                                       kernel_num_groups=None)],
                         rounds=ROUNDS, emit="kernel"), shards)):
        with pytest.raises(ValueError, match="scan-only members") as e:
            run(spec, data)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(TypeError, match="sequence of GLAs"):
        T.run_queries(T.QuerySpec(q6), shards, device="cpu")
    with pytest.raises(TypeError, match="run_queries"):
        T.run_query(T.QuerySpec([q6, q1]), shards, device="cpu")


@pytest.mark.parametrize("emit", ["kernel", "round"])
def test_bundle_rounds_degrade_with_a_warning(dims, shards, emit):
    """C=8 has no divisor 3: rounds degrade to 2, as in the reference."""
    _, glas = _glas(["q6", "q1-small"], dims)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = T.run_queries(T.QuerySpec(glas, rounds=3, emit=emit), shards,
                            device="cpu")
    assert any("degrading rounds 3 -> 2" in str(w.message) for w in rec)
    assert res[1].snapshots.sum.shape == (2, 4, 4)
    with pytest.raises(ValueError, match="non-uniform"):
        T.run_queries(T.QuerySpec(glas, emit=emit,
                                  schedule=np.array([[0, 1, 8]] * P)),
                      shards, device="cpu")


def _rel_widths(est):
    half = (np.asarray(est.upper, np.float64) - np.asarray(est.lower, np.float64)) / 2
    mid = np.abs(np.asarray(est.estimate, np.float64))
    rel = np.where(half == 0, 0.0, half / np.maximum(mid, 1e-300))
    return rel.reshape(rel.shape[0], -1).max(axis=1)


@pytest.mark.parametrize("emit", ["kernel", "round"])
def test_bundle_session_stops_when_every_member_converged(dims, ref_shards, shards,
                                                          emit):
    """rel_width over a bundle holds only when every estimating member has
    converged (a member without an estimator is skipped): the port stops
    after the reference's steps_taken, which is the slowest member's."""
    (rq6, rq1), (q6, q1) = _glas(["q6-dense", "q1-dense"], dims)
    rnone = RG.make_sum_gla(RT.q6_func, _dense_ref, d_total=D, estimator="none")
    tnone = T.make_sum_gla(TT.q6_func, _dense, d_total=D, estimator="none")
    full = REN.run_queries(RQuerySpec([rq6, rq1], rounds=8), ref_shards)
    widths = [_rel_widths(r.estimates) for r in full]
    eps = None
    for k in range(1, 8):  # the first round where both are under ε, with margin
        w_all = max(w[k] for w in widths)
        prev = min(max(w[j] for w in widths) for j in range(k))
        if np.isfinite(prev) and prev > w_all * 1.1 and widths[0][k] != widths[1][k]:
            eps = float(np.sqrt(prev * w_all))
            break
    assert eps is not None
    rs = RS.Session(RQuerySpec(RG.GLABundle([rq6, rnone, rq1]), rounds=8,
                               emit=emit, stop=RS.rel_width(eps)), ref_shards)
    rs.run()
    ts = T.Session(T.QuerySpec(T.GLABundle([q6, tnone, q1]), rounds=8, emit=emit,
                               stop=T.rel_width(eps)), shards, device="cpu")
    res = ts.run()
    assert ts.converged and ts.steps_taken == rs.steps_taken == k + 1
    solo = []
    for g in (q6, q1):
        s = T.Session(T.QuerySpec(g, rounds=8, emit=emit, stop=T.rel_width(eps)),
                      shards, device="cpu")
        s.run()
        solo.append(s.steps_taken)
    assert ts.steps_taken == max(solo) > min(solo), solo
    assert res.estimates[1] is None and res.estimates[0].estimate.shape[0] == k + 1
