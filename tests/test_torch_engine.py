"""Port parity for the query loop: ``repro_torch.run_query`` against the JAX
reference's ``run_query`` on the same packed shards.

The reference for every state is the reference's ``emit="chunk"`` scan: on
jax 0.9.0 the reference's own fused and scan group paths disagree bitwise,
so its kernel path is no oracle for group states.  The port runs
``emit="chunk"``, ``"round"`` and ``"kernel"`` (on the CPU the kernel
wrappers run their plain versions).

Tolerances: counters exact; f32 finals, snapshot sums and estimates
rtol=1e-5 with atol=1e-5·max|ref| (summation order differs); bound
half-widths rtol=1e-3 (Eq. (4)'s cancellation amplifies f32 rounding); the
+inf pattern exact and no NaN.
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
from repro.core.spec import QuerySpec as RQuerySpec
from repro.data import tpch as RT
from repro_torch import convert, randomize
from repro_torch.data import tpch as TT

P, C, L = 4, 8, 256
ROWS = P * C * L
ROUNDS = 4
RTOL = 1e-5
HALF_RTOL = 1e-3


@pytest.fixture(scope="module")
def raw():
    return RT.generate_lineitem(ROWS - 300, seed=9)  # ragged: padded tails


@pytest.fixture(scope="module")
def ref_shards(raw):
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in raw.items()},
                                jax.random.key(2), P)
    return RR.pack_partitions(parts, chunk_len=L, min_chunks=C)


@pytest.fixture(scope="module")
def shards(ref_shards):
    return convert.shards_from_reference(
        {k: np.asarray(v) for k, v in ref_shards.items()}, device="cpu")


def _pair(name):
    d = float(ROWS - 300)
    if name.startswith("q6"):
        win = RT.Q6_LOW_WINDOW if name == "q6-low" else RT.Q6_HIGH_WINDOW
        return (RG.make_sum_gla(RT.q6_func, RT.q6_cond(win), d_total=d),
                T.make_sum_gla(TT.q6_func, TT.q6_cond(win), d_total=d))
    if name == "q1-small":
        return (RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_small,
                                    num_groups=4, d_total=d, num_aggs=4),
                T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small,
                                   num_groups=4, d_total=d, num_aggs=4))
    kw = dict(num_groups=1000, bucket_bits=7, d_total=d, num_aggs=4)
    return (RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_large, **kw),
            T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_large, **kw))


_REF_CACHE = {}


def _reference(name, ref_shards, **plan):
    key = (name, tuple(sorted(plan.items())))
    if key not in _REF_CACHE:
        rgla, _ = _pair(name)
        _REF_CACHE[key] = REN.run_query(
            RQuerySpec(rgla, rounds=ROUNDS, emit="chunk", **plan), ref_shards)
    return _REF_CACHE[key]


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
    np.testing.assert_array_equal(got.d_local.numpy(), np.asarray(want.d_local))
    if want.snapshots is None:
        assert got.snapshots is None and got.estimates is None
        return
    for f in ("scanned", "matched"):
        np.testing.assert_array_equal(getattr(got.snapshots, f).numpy(),
                                      np.asarray(getattr(want.snapshots, f)), err_msg=f)
    for f in ("sum", "sumsq"):
        _close(getattr(got.snapshots, f), getattr(want.snapshots, f), RTOL, f)
    ge, we = got.estimates, want.estimates
    _close(ge.estimate, we.estimate, RTOL, "estimate")
    _close((ge.upper - ge.lower) / 2,
           (np.asarray(we.upper) - np.asarray(we.lower)) / 2, HALF_RTOL, "half-width")


@pytest.mark.parametrize("emit", ["chunk", "round", "kernel"])
@pytest.mark.parametrize("query", ["q6-low", "q6-high", "q1-small", "q1-bucketed"])
def test_run_query_matches_reference(shards, ref_shards, query, emit):
    want = _reference(query, ref_shards)
    _, tgla = _pair(query)
    got = T.run_query(T.QuerySpec(tgla, rounds=ROUNDS, emit=emit), shards,
                      device="cpu")
    _assert_result(got, want)


@pytest.mark.parametrize("plan", [
    {"sync": True},
    {"lanes": 2},
    {"alive": (1, 0, 1, 1)},
    {"snapshots": False},
    {"confidence": 0.5},
], ids=lambda p: next(iter(p)))
def test_plan_options_match_reference(shards, ref_shards, plan):
    want = _reference("q6-low", ref_shards, **plan)
    _, tgla = _pair("q6-low")
    got = T.run_query(T.QuerySpec(tgla, rounds=ROUNDS, emit="chunk", **plan),
                      shards, device="cpu")
    _assert_result(got, want)


def test_final_matches_float64_oracle(raw, shards):
    """The port's kernel-path final against the reference oracle's float64
    answer (the quickstart's 1e-3 check) and the port's own oracle."""
    _, tgla = _pair("q1-small")
    got = T.run_query(T.QuerySpec(tgla, rounds=ROUNDS, emit="kernel"), shards,
                      device="cpu").final.double().numpy()
    want = RT.exact_answer(raw, RT.q1_func, RT.q1_cond, RT.q1_group_small, 4)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    flat = {k: torch.from_numpy(v) for k, v in raw.items()}
    mine = TT.exact_answer(flat, TT.q1_func, TT.q1_cond, TT.q1_group_small, 4)
    np.testing.assert_allclose(mine.numpy(), want, rtol=1e-12)


def test_entry_points_refuse_a_missing_card(shards, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tgla = _pair("q6-low")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.run_query(T.QuerySpec(tgla, rounds=ROUNDS), shards)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Session(T.QuerySpec(tgla, rounds=ROUNDS), shards)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.generate_lineitem(16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.run_queries(T.QuerySpec([tgla, tgla], rounds=ROUNDS), shards)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.make_join_groupby_gla(TT.q6_func, TT.q1_cond, lambda c: c["suppkey"],
                                np.zeros(8, np.int32), np.ones(8, np.float32),
                                num_groups=2, d_total=1.0)


def test_plan_validation(shards, ref_shards):
    rq6, q6 = _pair("q6-low")
    _, q1 = _pair("q1-small")
    # without a fused contract emit="kernel" takes the legacy scalar path
    # (K4), as in the reference
    want = REN.run_query(RQuerySpec(rq6.with_(fused=None), rounds=ROUNDS,
                                    emit="kernel"), ref_shards)
    got = T.run_query(T.QuerySpec(q6.with_(fused=None), rounds=ROUNDS, emit="kernel"),
                      shards, device="cpu")
    _assert_result(got, want)
    with pytest.raises(ValueError, match="neither kernel_cols nor a fused"):
        T.run_query(T.QuerySpec(q6.with_(fused=None, kernel_cols=None),
                                emit="kernel"), shards, device="cpu")
    with pytest.raises(ValueError, match="unknown emit"):
        T.run_query(T.QuerySpec(q6, emit="rounds"), shards, device="cpu")
    with pytest.raises(ValueError, match="non-uniform"):
        sched = np.array([[0, 1, 8]] * P)
        T.run_query(T.QuerySpec(q1, emit="kernel", schedule=sched), shards,
                    device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = T.run_query(T.QuerySpec(q1, rounds=3, emit="kernel"), shards,
                          device="cpu")
    assert any("degrading rounds 3 -> 2" in str(w.message) for w in rec)
    assert res.snapshots.sum.shape == (2, 4, 4)
    with pytest.warns(DeprecationWarning):
        T.run_query(q6, shards, device="cpu", rounds=2)


def test_generator_and_randomizer_statistics():
    """The port draws from torch generators, so it is checked against the
    reference's distributions, not its numbers."""
    n = 200_000
    cols = TT.generate_lineitem(n, seed=1, device="cpu")
    ref = RT.generate_lineitem(n, seed=1)
    for k, v in cols.items():
        assert v.dtype == torch.from_numpy(ref[k]).dtype, k
        assert v.min().item() >= ref[k].min() and v.max().item() <= ref[k].max(), k
        np.testing.assert_allclose(v.double().mean().item(), ref[k].mean(),
                                   rtol=0.02, err_msg=k)
    assert set(np.unique(cols["discount"].numpy())) == set(np.unique(ref["discount"]))
    g = torch.Generator().manual_seed(3)
    parts = randomize.randomize_global(cols, g, 5)
    assert sum(p["shipdate"].shape[0] for p in parts) == n
    allv = torch.cat([p["extendedprice"] for p in parts])
    assert torch.equal(allv.sort().values, cols["extendedprice"].sort().values)
    # global randomization: every partition is a uniform sample
    sel = [TT.q1_cond(p).mean().item() for p in parts]
    np.testing.assert_allclose(sel, TT.q1_cond(cols).mean().item(), rtol=0.1)
    packed = randomize.pack_partitions(parts, chunk_len=1000)
    assert packed["_mask"].shape == (5, 40, 1000)
    assert packed["_mask"].sum().item() == n
