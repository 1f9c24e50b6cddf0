"""Port parity: ``repro_torch.estimators`` and the GLA hashing against the
JAX reference, function by function, on the same numpy inputs.

Tolerances: f32 estimates rtol=1e-5 (both compute the same float32
expression; only transcendental rounding differs), bound half-widths
rtol=1e-3 (Eq. (4) subtracts sum^2 from |S|·sumsq, and that cancellation
amplifies f32 rounding), the +inf pattern exact and no NaN anywhere.
Bucket ids are compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import estimators as RE
from repro.core import gla as RG
from repro_torch import convert
from repro_torch import estimators as TE
from repro_torch import gla as TG
from repro_torch.uda import tree_map

EST_RTOL = 1e-5
HALF_RTOL = 1e-3


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _close(a, b, rtol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert np.array_equal(np.isinf(a), np.isinf(b))
    assert not np.isnan(a).any() and not np.isnan(b).any()
    fin = np.isfinite(b)
    atol = rtol * max(np.abs(b[fin]).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=atol)


def _inputs(seed, n=64):
    rng = np.random.default_rng(seed)
    scanned = rng.integers(0, 50, n).astype(np.float32)
    scanned[:4] = [0, 1, 2, 3]  # the |S| < 2 gate and its edge
    vals = rng.uniform(0.0, 10.0, (n, 8)).astype(np.float32)
    hits = (np.arange(8)[None, :] < scanned[:, None]).astype(np.float32)
    s = (vals * hits).sum(1).astype(np.float32)
    q = (vals * vals * hits).sum(1).astype(np.float32)
    return s, q, scanned


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d_total", [60.0, 1e6])
def test_horvitz_and_variance_match_reference(seed, d_total):
    s, q, n = _inputs(seed)
    _close(TE.horvitz_estimate(_t(s), _t(n), d_total),
           RE.horvitz_estimate(jnp.asarray(s), jnp.asarray(n), d_total), EST_RTOL)
    var_t = TE.variance_estimate(_t(s), _t(q), _t(n), d_total)
    var_r = RE.variance_estimate(jnp.asarray(s), jnp.asarray(q), jnp.asarray(n),
                                 d_total)
    _close(var_t, var_r, HALF_RTOL)
    assert torch.equal(torch.isinf(var_t), torch.from_numpy(n < 2))


@pytest.mark.parametrize("confidence", [0.5, 0.9, 0.95, 0.99])
def test_zq_and_bounds_match_reference(confidence):
    np.testing.assert_allclose(float(TE.zq(confidence)),
                               float(RE.zq(confidence)), rtol=1e-6)
    s, q, n = _inputs(7)
    d = 1e4
    e_t = TE.single_estimate(TE.SumState(_t(s), _t(q), _t(n), _t(n)),
                             confidence, d_total=d)
    e_r = RE.single_estimate(RE.SumState(*(jnp.asarray(x) for x in (s, q, n, n))),
                             confidence, d_total=d)
    _close(e_t.estimate, e_r.estimate, EST_RTOL)
    _close((e_t.upper - e_t.lower) / 2, (np.asarray(e_r.upper)
                                         - np.asarray(e_r.lower)) / 2, HALF_RTOL)
    _close(e_t.info["frac"], e_r.info["frac"], EST_RTOL)


@settings(max_examples=25, deadline=None, database=None)
@given(st.integers(min_value=0, max_value=1 << 30),
       st.floats(min_value=0.0, max_value=1e6))
def test_small_sample_variance_is_inf_never_nan(scanned, total):
    """|S| < 2 gives +inf; any |S| gives no NaN — including sum == 0."""
    s = torch.tensor([0.0, total], dtype=torch.float32)
    var = TE.variance_estimate(s, s * s, torch.tensor(float(scanned)), 1e9)
    assert not torch.isnan(var).any()
    assert bool(torch.isinf(var).all()) == (scanned < 2)


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(st.integers(min_value=-(1 << 31), max_value=(1 << 31) - 1),
                min_size=1, max_size=64),
       st.integers(min_value=1, max_value=20))
def test_hash_bucket_ids_equal_reference(ids, bits):
    a = np.asarray(ids, np.int32)
    got = TG.hash_bucket(torch.from_numpy(a), bits).numpy()
    want = np.asarray(RG.hash_bucket(jnp.asarray(a), bits))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [7, 13, 32])
def test_hash_bucket_full_ranges_equal_reference(bits):
    a = np.concatenate([np.arange(0, 100_000, dtype=np.int32),
                        np.array([-1, -(1 << 31), (1 << 31) - 1], np.int32)])
    got = TG.hash_bucket(torch.from_numpy(a), bits).numpy()
    np.testing.assert_array_equal(got, np.asarray(RG.hash_bucket(jnp.asarray(a), bits)))


def test_masked_matches_reference():
    from repro.core.uda import masked as ref_masked
    from repro_torch.uda import masked

    rng = np.random.default_rng(4)
    cond = (rng.random(32) < 0.5).astype(np.float32)
    chunk = {"_mask": (rng.random(32) < 0.7).astype(np.float32)}
    got = masked(torch.from_numpy(cond), {"_mask": torch.from_numpy(chunk["_mask"])})
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_masked(cond, chunk)))


def test_debucket_matches_reference():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(128, 4)).astype(np.float32)
    raw = np.arange(100, dtype=np.int32)
    got = TG.debucket(torch.from_numpy(table), torch.from_numpy(raw), 7).numpy()
    np.testing.assert_array_equal(got, np.asarray(RG.debucket(table, raw, 7)))
    # an injective domain (100 raw ids <= 2**7 buckets) hits distinct rows
    assert len({tuple(r) for r in got}) == 100


# ---------------------------------------------------------------------------
# the multiple-estimators (stratified) model, paper Alg. 2
# ---------------------------------------------------------------------------

def _mult_pair(seed, A=2):
    """One MultState per partition (4 of them) in both packages."""
    rng = np.random.default_rng(seed)
    scanned = rng.integers(0, 40, 4).astype(np.float32)
    scanned[:2] = [0, 1]  # the |S| < 2 clamp
    s = rng.uniform(0, 50, (4, A)).astype(np.float32) * (scanned[:, None] > 0)
    q = (s * s / np.maximum(scanned[:, None], 1) * 1.5).astype(np.float32)
    d_local = (scanned + rng.integers(0, 100, 4)).astype(np.float32)
    z = np.zeros((4, A), np.float32)
    stacked = RE.MultState(RE.SumState(s, q, scanned, scanned), z, z)  # numpy leaves
    r = [RE.MultState(RE.SumState(*(jnp.asarray(x[i]) for x in (s, q, scanned, scanned))),
                      jnp.asarray(z[i]), jnp.asarray(z[i])) for i in range(4)]
    return convert.mult_state_from_reference(stacked, device="cpu"), r, d_local


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mult_terminate_merge_estimate_match_reference(seed):
    t, r, d_local = _mult_pair(seed)
    tt = TE.mult_estimator_terminate(t, d_local=_t(d_local))
    rt = [RE.mult_estimator_terminate(x, d_local=jnp.float32(d))
          for x, d in zip(r, d_local)]
    back = convert.state_to_numpy(tt)
    assert isinstance(back, TE.MultState) and isinstance(back.est, np.ndarray)
    _close(back.est, np.stack([np.asarray(x.est) for x in rt]), EST_RTOL)
    _close(back.estvar, np.stack([np.asarray(x.estvar) for x in rt]), HALF_RTOL)
    assert torch.isinf(tt.estvar[:2]).all()  # 0 or 1 rows scanned: +inf, never NaN
    merged = TE.mult_estimator_merge(tree_map(lambda v: v[0], tt),
                                     tree_map(lambda v: v[2], tt))
    rmerged = RE.mult_estimator_merge(rt[0], rt[2])
    _close(merged.est, rmerged.est, EST_RTOL)
    _close(merged.estvar, rmerged.estvar, HALF_RTOL)
    np.testing.assert_array_equal(merged.base.scanned.numpy(),
                                  np.asarray(rmerged.base.scanned))
    e_t, e_r = TE.mult_estimate(merged, 0.95), RE.mult_estimate(rmerged, 0.95)
    _close(e_t.estimate, e_r.estimate, EST_RTOL)
    _close(e_t.upper - e_t.lower, np.asarray(e_r.upper) - np.asarray(e_r.lower),
           HALF_RTOL)


@settings(max_examples=25, deadline=None, database=None)
@given(st.integers(min_value=0, max_value=1), st.floats(min_value=0.0, max_value=1e6))
def test_mult_small_partition_variance_is_inf_never_nan(scanned, total):
    b = TE.SumState(torch.tensor([total * scanned]), torch.tensor([total ** 2 * scanned]),
                    torch.tensor(float(scanned)), torch.tensor(float(scanned)))
    z = torch.zeros(1)
    st_ = TE.mult_estimator_terminate(TE.MultState(b, z, z), d_local=torch.tensor(100.0))
    e = TE.mult_estimate(st_, 0.95)
    assert torch.isposinf(st_.estvar).all() and not torch.isnan(st_.est).any()
    assert torch.isneginf(e.lower).all() and torch.isposinf(e.upper).all()


def test_mult_state_zero_matches_reference():
    got, want = TE.mult_state_zero(), RE.mult_state_zero()
    for a, b in zip((*got.base, got.est, got.estvar), (*want.base, want.est, want.estvar)):
        assert a.shape == b.shape and float(a) == float(b) == 0.0


def _multiple_glas(kind):
    from repro.data import tpch as RT
    from repro_torch.data import tpch as TT
    d = 8192.0
    if kind == "sum":
        return (RG.make_sum_gla(RT.q6_func, RT.q6_cond(RT.Q6_LOW_WINDOW), d_total=d,
                                estimator="multiple"),
                TG.make_sum_gla(TT.q6_func, TT.q6_cond(TT.Q6_LOW_WINDOW), d_total=d,
                                estimator="multiple"))
    return (RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_small, num_groups=4,
                                d_total=d, num_aggs=4, estimator="multiple"),
            TG.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small, num_groups=4,
                                d_total=d, num_aggs=4, estimator="multiple"))


@pytest.fixture(scope="module")
def mult_shards():
    import jax
    from repro.core import randomize as RR
    from repro.data import tpch as RT
    raw = RT.generate_lineitem(8192, seed=21)
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in raw.items()},
                                jax.random.key(4), 4)
    ref = RR.pack_partitions(parts, chunk_len=256)
    return ref, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}


@pytest.mark.parametrize("emit", ["chunk", "round"])
@pytest.mark.parametrize("kind", ["sum", "groupby"])
def test_multiple_gla_runs_match_reference(mult_shards, kind, emit):
    import repro_torch as T
    from repro.core import engine as REN
    from repro.core.spec import QuerySpec as RQuerySpec
    ref_shards, t_shards = mult_shards
    rg, tg = _multiple_glas(kind)
    assert tg.name == rg.name and tg.fused is None and tg.kernel_cols is None
    want = REN.run_query(RQuerySpec(rg, rounds=4, emit=emit), ref_shards)
    got = T.run_query(T.QuerySpec(tg, rounds=4, emit=emit), t_shards, device="cpu")
    _close(got.estimates.estimate, want.estimates.estimate, EST_RTOL)
    _close((got.estimates.upper - got.estimates.lower) / 2,
           (np.asarray(want.estimates.upper) - np.asarray(want.estimates.lower)) / 2,
           HALF_RTOL)
    _close(got.snapshots.est, want.snapshots.est, EST_RTOL)
    _close(got.snapshots.estvar, want.snapshots.estvar, HALF_RTOL)
    np.testing.assert_array_equal(got.snapshots.base.scanned.numpy(),
                                  np.asarray(want.snapshots.base.scanned))
    _close(got.final, want.final, 1e-6)


def test_multiple_gla_is_refused_on_kernel_emission(mult_shards):
    """No kernel publishes MultState: emit="kernel" refuses it with the
    reference's message; a bundle of multiple members runs on the scan
    paths and matches the reference's run_queries."""
    import repro_torch as T
    from repro.core import engine as REN
    from repro.core.spec import QuerySpec as RQuerySpec
    ref_shards, t_shards = mult_shards
    (rs, ts), (rq, tq) = _multiple_glas("sum"), _multiple_glas("groupby")
    with pytest.raises(ValueError, match="publishes neither kernel_cols nor a fused"):
        T.run_query(T.QuerySpec(ts, emit="kernel"), t_shards, device="cpu")
    got = T.run_queries(T.QuerySpec([ts, tq], rounds=4), t_shards, device="cpu")
    want = REN.run_queries(RQuerySpec([rs, rq], rounds=4), ref_shards)
    for g, w in zip(got, want, strict=True):
        _close(g.estimates.estimate, w.estimates.estimate, EST_RTOL)
        _close(g.final, w.final, 1e-6)
