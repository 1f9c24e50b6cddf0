"""Sketch GLAs (``repro_torch.sketch``) and ``monotone_envelope`` in the port,
against the reference's on the same shards.

The port of the sketch and envelope tests of ``tests/test_deepola.py``, plus
parity with the reference: the same inputs (shards built once with the
reference's randomizer and packer, converted with ``repro_torch.convert``)
through both packages.  The reference's runs are its ``emit="chunk"`` scan.

Tolerances:
  * HLL registers and ``scanned``: bitwise (max is order-free);
  * quantile edges, counts, ``scanned``, ``matched`` and est/lo/hi: bitwise
    (integer-valued counts, float32 edges computed as the reference's);
  * CMS table, ``scanned``, ``matched``: bitwise;
  * HLL and CMS estimates and bounds: rtol 1e-6 (``zq`` and the register
    sum are computed by another library);
  * ``_mix32`` and the CMS buckets: bitwise over int32 edge keys and a
    hypothesis strategy;
  * ``monotone_envelope`` against the reference's: bitwise, over random
    bounds with crossings and ±inf;
  * the reference tests' own error-model checks as they state them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch as T
from repro.core import engine as REN
from repro.core import estimators as RE
from repro.core import randomize as RR
from repro.core import session as RSN
from repro.core import sketch as RS
from repro.core import spec as RSP
from repro.data import tpch as RT
from repro_torch import convert
from repro_torch import sketch as TS
from repro_torch.data import tpch as TT
from repro_torch.uda import tree_map

ROWS = 12_000
PARTS = 4
D = float(ROWS)
ROUNDS = 4
EST_RTOL = 1e-6
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
EDGE_KEYS = np.array([0, -1, INT32_MAX, INT32_MIN, 1, 65535, 65536, 12345],
                     np.int32)


def _pack(cols, *, key, chunk=256):
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in cols.items()},
                                jax.random.key(key), PARTS)
    ref = {k: np.asarray(v) for k, v in
           RR.pack_partitions(parts, chunk_len=chunk).items()}
    return ref, convert.shards_from_reference(ref, device="cpu")


@functools.lru_cache(maxsize=None)
def _sketch_shards():
    rng = np.random.default_rng(3)
    cols = {"k": (np.arange(ROWS, dtype=np.int32) % 3000),
            "v": rng.random(ROWS).astype(np.float32),
            "h": (np.arange(ROWS, dtype=np.int32) % 100)}
    return _pack(cols, key=11)


@functools.lru_cache(maxsize=None)
def _lineitem_shards():
    return _pack(RT.generate_lineitem(ROWS, seed=23), key=5)


@functools.lru_cache(maxsize=None)
def _q3():
    cols, q3, (segment, valid) = RT.q3_scenario(ROWS)
    ref, shards = _pack(cols, key=5)
    port = T.make_join_groupby_gla(
        TT.q6_func, TT.q1_cond, TT.orderkey, segment, valid,
        num_groups=TT.NUM_SEGMENTS, d_total=D, device="cpu")
    return ref, shards, q3, port


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _est_close(got, want, what):
    for f in ("estimate", "lower", "upper"):
        a, b = _np(getattr(got, f)), _np(getattr(want, f))
        assert a.shape == b.shape, (what, f)
        np.testing.assert_allclose(a, b, rtol=EST_RTOL, err_msg=f"{what} {f}")


def _ref_run(gla, ref_shards, **plan):
    return REN.run_query(RSP.QuerySpec(gla, rounds=ROUNDS, **{"emit": "chunk", **plan}),
                         ref_shards)


def _port_run(gla, shards, **plan):
    return T.run_query(T.QuerySpec(gla, rounds=ROUNDS, **plan), shards, device="cpu")


def _pair(name):
    if name == "hll":
        return (RS.make_count_distinct_gla(lambda c: c["k"], d_total=D),
                T.make_count_distinct_gla(lambda c: c["k"], d_total=D))
    if name == "quantile":
        return (RS.make_quantile_gla(lambda c: c["v"], lo=0.0, hi=1.0, d_total=D),
                T.make_quantile_gla(lambda c: c["v"], lo=0.0, hi=1.0, d_total=D))
    return (RS.make_heavy_hitters_gla(lambda c: c["h"], np.arange(3), d_total=D),
            T.make_heavy_hitters_gla(lambda c: c["h"], np.arange(3), d_total=D))


_REF = {}


def _reference(name, **plan):
    key = (name, tuple(sorted((k, str(v)) for k, v in plan.items())))
    if key not in _REF:
        _REF[key] = _ref_run(_pair(name)[0], _sketch_shards()[0], **plan)
    return _REF[key]


def _assert_sketch_matches(name, got, want):
    for f in want.snapshots._fields:
        assert _bits(getattr(got.snapshots, f), getattr(want.snapshots, f)), f
    if name == "quantile":
        assert _bits(got.final, want.final)
        for f in ("estimate", "lower", "upper"):
            assert _bits(getattr(got.estimates, f), getattr(want.estimates, f)), f
    else:
        np.testing.assert_allclose(_np(got.final), _np(want.final), rtol=EST_RTOL)
        _est_close(got.estimates, want.estimates, name)


# ---------------------------------------------------------------------------
# hashing: bitwise the reference's uint32 arithmetic
# ---------------------------------------------------------------------------

def _mix32_pair(keys):
    want = np.asarray(RS._mix32(jnp.asarray(keys))).astype(np.int64)
    got = TS._mix32(torch.from_numpy(np.asarray(keys))).numpy()
    return got, want


def _cms_tables(keys, W=64, D_=4):
    """One accumulate of ``keys`` into each package's CMS (all rows live),
    and both terminate counts for the keys themselves as candidates."""
    keys = np.asarray(keys, np.int32)
    ref = RS.make_heavy_hitters_gla(lambda c: c["k"], keys, d_total=D, width=W,
                                    depth=D_)
    port = T.make_heavy_hitters_gla(lambda c: c["k"], keys, d_total=D, width=W,
                                    depth=D_)
    rs = ref.accumulate(ref.init(), {"k": jnp.asarray(keys),
                                     "_mask": jnp.ones(len(keys), jnp.float32)})
    ts = port.accumulate(
        tree_map(lambda x: x.expand(1, *x.shape), port.init("cpu")),
        {"k": torch.from_numpy(keys)[None], "_mask": torch.ones((1, len(keys)))})
    return (ts.table[0], rs.table), (port.terminate(ts)[0], ref.terminate(rs))


def test_mix32_and_cms_buckets_bitwise_on_edge_keys():
    got, want = _mix32_pair(EDGE_KEYS)
    assert np.array_equal(got, want) and got.min() >= 0 and got.max() < 2**32
    tables, counts = _cms_tables(EDGE_KEYS)
    assert _bits(*tables) and _bits(*counts)


def test_float_keys_truncate_as_the_reference():
    keys = np.array([0.0, 1.5, 2.9, 7.0, 1e6 + 0.75, 65535.99], np.float32)
    got, want = _mix32_pair(keys)
    assert np.array_equal(got, want)


@settings(max_examples=25, deadline=None, database=None)
@given(st.lists(st.integers(INT32_MIN, INT32_MAX), min_size=1, max_size=64))
def test_mix32_and_cms_buckets_bitwise_property(keys):
    keys = np.asarray(keys, np.int32)
    got, want = _mix32_pair(keys)
    assert np.array_equal(got, want)
    tables, counts = _cms_tables(keys)
    assert _bits(*tables) and _bits(*counts)


# ---------------------------------------------------------------------------
# sketch states and estimates against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("emit,lanes", [("chunk", 1), ("round", 1), ("kernel", None),
                                        ("chunk", 2), ("round", 2),
                                        ("round_masked", 1), ("round_masked", 2)])
@pytest.mark.parametrize("name", ["hll", "quantile", "cms"])
def test_sketch_matches_reference(name, emit, lanes):
    """Every scan path, with lanes (the non-additive lane fold for HLL):
    states bitwise the reference's.  The sketches publish no kernel
    contract: ``emit="kernel"`` is refused, as by the reference."""
    ref_gla, gla = _pair(name)
    shards = _sketch_shards()[1]
    if emit == "kernel":
        with pytest.raises(ValueError) as e:
            _port_run(gla, shards, emit="kernel")
        with pytest.raises(ValueError) as r:
            _ref_run(ref_gla, _sketch_shards()[0], emit="kernel")
        assert str(e.value) == str(r.value)
        assert "publishes neither kernel_cols nor a fused kernel contract" in str(e.value)
        return
    got = _port_run(gla, shards, emit=emit, lanes=lanes)
    _assert_sketch_matches(name, got, _reference(name))


@pytest.mark.parametrize("name", ["hll", "quantile", "cms"])
def test_sketch_on_a_straggler_schedule_matches_reference(name):
    """``emit="round_masked"`` over per-partition windows against the
    reference's prefix states gathered at the same schedule."""
    shards = _sketch_shards()[1]
    sched = T.straggler_schedule(PARTS, shards["_mask"].shape[1], ROUNDS,
                                 [1.0, 1.0, 0.5, 0.25], seed=3)
    got = _port_run(_pair(name)[1], shards, emit="round_masked", schedule=sched)
    _assert_sketch_matches(name, got, _reference(name, schedule=sched))


@pytest.mark.parametrize("name", ["hll", "quantile", "cms"])
def test_sketch_session_bitwise_its_run_query(name):
    shards = _sketch_shards()[1]
    gla = _pair(name)[1]
    sess = T.Session(T.QuerySpec(gla, rounds=ROUNDS, emit="round"), shards, device="cpu")
    while not sess.done:
        sess.step()
    a, b = sess.result(), _port_run(gla, shards, emit="round")
    assert all(_bits(x, y) for x, y in zip(
        [*a.snapshots, a.final, *a.estimates[:3]], [*b.snapshots, b.final, *b.estimates[:3]]))


def _tree_pair(name, m, tpch):
    """The [sketch] phase's trees, at a small size, in module ``m``."""
    if name == "count-distinct":
        return m.CountDistinct(m.Scan(D), lambda c: c["suppkey"], log2m=12)
    if name == "quantile":
        return m.Quantile(m.Filter(m.Scan(D), tpch.q1_cond),
                          lambda c: c["extendedprice"], lo=0.9, hi=105.0,
                          bins=256, q=0.5)
    return m.HeavyHitters(m.Scan(D), lambda c: c["quantity"].astype(jnp.int32)
                          if m is RSP else c["quantity"].to(torch.int32),
                          np.arange(1, 51), width=1024, depth=4)


@pytest.mark.parametrize("name", ["count-distinct", "quantile", "heavy-hitters"])
def test_sketch_trees_match_the_reference_trees(name):
    ref_shards, shards = _lineitem_shards()
    want = _ref_run(_tree_pair(name, RSP, RT), ref_shards)
    got = _port_run(_tree_pair(name, T, TT), shards)
    _assert_sketch_matches({"count-distinct": "hll", "heavy-hitters": "cms"}.get(
        name, name), got, want)


def test_quantile_edges_bitwise():
    """Every edge of the f32 grid, read through terminate: a one-hot count
    at bin i puts the median at edge i; no count at all, at edge B."""
    for lo, hi, bins in ((0.9, 105.0, 256), (-3.3, 7.1, 100)):
        ref = RS.make_quantile_gla(lambda c: c["v"], lo=lo, hi=hi, d_total=D, bins=bins)
        port = T.make_quantile_gla(lambda c: c["v"], lo=lo, hi=hi, d_total=D, bins=bins)
        counts = np.concatenate([np.eye(bins, dtype=np.float32),
                                 np.zeros((1, bins), np.float32)])
        ones = np.ones(bins + 1, np.float32)
        want = jax.vmap(ref.terminate)(RS.HistState(
            jnp.asarray(counts), jnp.asarray(ones), jnp.asarray(ones)))
        got = port.terminate(TS.HistState(torch.from_numpy(counts),
                                          torch.from_numpy(ones), torch.from_numpy(ones)))
        assert _bits(got, want)


# ---------------------------------------------------------------------------
# the reference's own sketch tests, on the port
# ---------------------------------------------------------------------------

def test_sketch_additivity_flags():
    """HLL is a max monoid — one process only; the histogram and CMS
    sketches are additive and may run over mesh=."""
    hll = T.make_count_distinct_gla(lambda c: c["k"], d_total=D)
    qtl = T.make_quantile_gla(lambda c: c["v"], lo=0.0, hi=1.0, d_total=D)
    cms = T.make_heavy_hitters_gla(lambda c: c["h"], np.arange(3), d_total=D)
    assert not hll.merge_is_additive
    assert qtl.merge_is_additive and cms.merge_is_additive
    assert [g.name for g in (hll, qtl, cms)] == [g.name for g in (
        _pair("hll")[0], _pair("quantile")[0], _pair("cms")[0])]


def test_hll_count_distinct_within_error_model():
    res = _port_run(_pair("hll")[1], _sketch_shards()[1])
    est = float(res.final)
    rel = abs(est - 3000.0) / 3000.0
    assert rel < 0.1, f"HLL off by {rel:.1%}"
    e = res.estimates
    assert float(e.lower[-1]) <= est <= float(e.upper[-1])


def test_quantile_dkw_band_contains_truth():
    res = _port_run(_pair("quantile")[1], _sketch_shards()[1])
    est = float(res.final)
    assert abs(est - 0.5) < 0.05
    assert float(res.estimates.lower[-1]) <= 0.5 <= float(res.estimates.upper[-1])


def test_heavy_hitters_cms_bounds():
    res = _port_run(_pair("cms")[1], _sketch_shards()[1])
    est = res.final.numpy()  # full-scan counts
    true = np.asarray([np.sum(np.arange(ROWS) % 100 == c) for c in range(3)],
                      np.float32)
    assert (est >= true - 1e-3).all()  # CMS never undercounts
    lo, hi = res.estimates.lower[-1].numpy(), res.estimates.upper[-1].numpy()
    assert (lo <= true).all() and (true <= hi).all()


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_hll_under_a_fault_policy_is_refused_with_the_reference_message(pkg):
    ref_shards, shards = _sketch_shards()
    want = ("FaultPolicy needs additive merges: excluding dead partitions is a "
            "weighted merge, which non-additive GLAs cannot honor")
    with pytest.raises(ValueError) as e:
        if pkg == "repro":
            RSN.Session(RSP.QuerySpec(_pair("hll")[0], rounds=ROUNDS,
                                      fault=RSN.FaultPolicy("single")), ref_shards)
        else:
            T.Session(T.QuerySpec(_pair("hll")[1], rounds=ROUNDS,
                                  fault=T.FaultPolicy("single")), shards, device="cpu")
    assert str(e.value) == want


# ---------------------------------------------------------------------------
# monotone_envelope
# ---------------------------------------------------------------------------

@settings(max_examples=50, deadline=None, database=None)
@given(st.lists(st.floats(-1e6, 1e6), min_size=1, max_size=24),
       st.lists(st.floats(0.0, 1e6), min_size=1, max_size=24))
def test_monotone_envelope_never_widens(mids, halves):
    """However HAVING flips bounce the raw per-round CIs around, the
    envelope only tightens and stays valid (lo <= hi), across crossings."""
    n = min(len(mids), len(halves))
    mid = np.asarray(mids[:n], np.float32)
    half = np.asarray(halves[:n], np.float32)
    lo, hi = T.monotone_envelope(mid - half, mid + half)
    lo, hi = lo.numpy(), hi.numpy()
    assert (np.diff(lo) >= 0).all()  # lower bound never drops
    assert (np.diff(hi) <= 0).all()  # upper bound never rises
    assert (lo <= hi).all()


_BOUND = st.one_of(st.floats(-1e6, 1e6, width=32),
                   st.sampled_from([np.inf, -np.inf]))


@settings(max_examples=50, deadline=None, database=None)
@given(st.integers(1, 12), st.integers(1, 3), st.data())
def test_monotone_envelope_bitwise_the_reference(rounds, groups, data):
    """Any bounds, crossing or not, with ±inf rounds, [R] and [R, G]."""
    n = rounds * groups
    lower = np.asarray(data.draw(st.lists(_BOUND, min_size=n, max_size=n)),
                       np.float32).reshape(rounds, groups)
    upper = np.asarray(data.draw(st.lists(_BOUND, min_size=n, max_size=n)),
                       np.float32).reshape(rounds, groups)
    for lo_, hi_ in ((lower, upper), (lower[:, 0], upper[:, 0])):
        want = RE.monotone_envelope(lo_, hi_)
        got = T.monotone_envelope(lo_, hi_)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and _bits(a, b)


@pytest.mark.parametrize("lower,upper", [
    ([0.0, -0.0], [0.0, 0.0]),  # a running max over 0.0 then -0.0 stays 0.0
    ([-0.0, -0.0, 0.0, -0.0], [0.0, -0.0, 0.0, 0.0]),  # a running min keeps -0.0
    ([-1.0, -0.0, 0.0], [1.0, 0.0, -0.0]),
])
def test_monotone_envelope_orders_signed_zeros_as_the_reference(lower, upper):
    lo, hi = (np.asarray(x, np.float32) for x in (lower, upper))
    for a, b in zip(T.monotone_envelope(lo, hi), RE.monotone_envelope(lo, hi)):
        assert _bits(a, b)


@pytest.mark.parametrize("lower,upper", [
    ([0.0], [-1.64e-42]),  # crossed only unflushed: the bits pass through
    ([-1e-40], [-2e-40]),
    ([[1e-40], [0.0]], [[2e-40], [-1e-40]]),  # running bounds come out flushed
    ([1.0, 5e-39, -1.64e-42], [2.0, 1e-40, 3.0]),
])
def test_monotone_envelope_reads_subnormal_bounds_as_the_reference(lower, upper):
    lo, hi = (np.asarray(x, np.float32) for x in (lower, upper))
    for a, b in zip(T.monotone_envelope(lo, hi), RE.monotone_envelope(lo, hi)):
        assert _bits(a, b)


def test_monotone_envelope_with_inf_rounds():
    """±inf rounds (poisoned early bounds) pass through: the envelope keeps
    the tightest finite bounds seen so far."""
    lo = np.asarray([-np.inf, 1.0, -np.inf, 2.0], np.float32)
    hi = np.asarray([np.inf, 9.0, np.inf, 8.0], np.float32)
    elo, ehi = T.monotone_envelope(lo, hi)
    np.testing.assert_array_equal(elo.numpy(), [-np.inf, 1.0, 1.0, 2.0])
    np.testing.assert_array_equal(ehi.numpy(), [np.inf, 9.0, 9.0, 8.0])


def test_monotone_envelope_keeps_tensor_dtype_and_freezes():
    lo = torch.tensor([1.0, 5.0, 0.0], dtype=torch.float64)
    hi = torch.tensor([3.0, 6.0, 1.0], dtype=torch.float64)
    elo, ehi = T.monotone_envelope(lo, hi)  # round 1 crosses: frozen at round 0
    assert elo.dtype == ehi.dtype == torch.float64
    assert elo.tolist() == [1.0, 1.0, 1.0] and ehi.tolist() == [3.0, 3.0, 3.0]
    mid = T.monotone_envelope(torch.tensor([4.0]), torch.tensor([2.0]))
    assert [x.item() for x in mid] == [3.0, 3.0]  # round-0 crossing: midpoint


def test_having_flip_rounds_still_give_monotone_envelope():
    """End to end: a threshold near a group's estimate flips membership
    across rounds; raw bounds may jump, the envelope must not widen, and
    the port's raw bounds are the reference's."""
    ref_shards, shards, ref_q3, q3 = _q3()
    res = T.run_query(T.QuerySpec(T.make_having_gla(q3, 1200.0), rounds=6), shards,
                      device="cpu")
    lo, hi = res.estimates.lower.numpy(), res.estimates.upper.numpy()
    elo, ehi = (x.numpy() for x in T.monotone_envelope(lo, hi))
    assert (np.diff(elo) >= -1e-6).all() and (np.diff(ehi) <= 1e-6).all()
    assert (elo <= ehi + 1e-6).all()
    assert not np.isnan(np.concatenate([lo, hi])).any()
    from repro.core import gla as RG

    want = REN.run_query(RSP.QuerySpec(RG.make_having_gla(ref_q3, 1200.0), rounds=6,
                                       emit="chunk"), ref_shards)
    np.testing.assert_allclose(lo, np.asarray(want.estimates.lower), rtol=1e-5)
    np.testing.assert_allclose(hi, np.asarray(want.estimates.upper), rtol=1e-5)
