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
from repro_torch import estimators as TE
from repro_torch import gla as TG

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
