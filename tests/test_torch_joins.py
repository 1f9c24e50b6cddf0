"""Port parity for joins (paper Alg. 4, §4.5): ``make_join_groupby_gla``
against the reference's on the same packed shards and the same dimension
tables — TPC-H Q3 (one SUM per order segment) and Q10 (four SUMs), with a
small orders table (fused kernel path) and with one past the reference's
probe budget (``PROBE_VMEM_BUDGET_BYTES // 4 + 1`` orders: the legacy K3
path).  Routing, results on ``emit`` "chunk" and "kernel", the ``d_dim``
scale and the float64 join oracle.

Tolerances: counters exact; f32 finals, snapshot sums and estimates
rtol=1e-5 with atol=1e-5·max|ref| (summation order differs); half-widths
rtol=1e-3; finals against the float64 oracle rtol=1e-3 (the quickstart's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as T
from repro.core import engine as REN
from repro.core import estimators as RE
from repro.core import gla as RG
from repro.core import randomize as RR
from repro.core import session as RS
from repro.core.spec import QuerySpec as RQuerySpec
from repro.data import tpch as RT
from repro.kernels import fused_agg as RFK
from repro_torch import convert
from repro_torch import estimators as TE
from repro_torch.data import tpch as TT
from repro_torch.kernels import fused_agg as FK

P, C, L = 4, 12, 256
ROWS = P * C * L - 200  # ragged: padded tails
ROUNDS = 4
BIG = RFK.PROBE_VMEM_BUDGET_BYTES // 4 + 1  # orders past the probe budget
RTOL = 1e-5
HALF_RTOL = 1e-3
D = float(ROWS)


@pytest.fixture(scope="module")
def raw():
    cols = RT.generate_lineitem(ROWS, seed=31)
    cols["orderkey"] = RT.generate_orders_fk(ROWS, seed=31)
    cols["orderkey_big"] = RT.generate_orders_fk(ROWS, num_orders=BIG, seed=32)
    return cols


@pytest.fixture(scope="module")
def dims():
    return {"small": RT.orders_table(ROWS // 4, seed=38),
            "big": RT.orders_table(BIG, seed=39)}


@pytest.fixture(scope="module")
def ref_shards(raw):
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in raw.items()},
                                jax.random.key(4), P)
    return RR.pack_partitions(parts, chunk_len=L, min_chunks=C)


@pytest.fixture(scope="module")
def shards(ref_shards):
    return convert.shards_from_reference(
        {k: np.asarray(v) for k, v in ref_shards.items()}, device="cpu")


def _key(size):
    col = "orderkey" if size == "small" else "orderkey_big"
    return lambda c: c[col]


def _pair(query, size, dims, **kw):
    """(reference GLA, port GLA) for Q3 or Q10 against the ``size`` dim."""
    seg, valid = dims[size]
    r_func, t_func, A = ((RT.q6_func, TT.q6_func, 1) if query == "q3"
                         else (RT.q1_func, TT.q1_func, 4))
    common = dict(num_groups=RT.NUM_SEGMENTS, d_total=D, num_aggs=A, **kw)
    return (RG.make_join_groupby_gla(r_func, RT.q1_cond, _key(size), seg, valid,
                                     **common),
            T.make_join_groupby_gla(t_func, TT.q1_cond, _key(size), seg, valid,
                                    device="cpu", **common))


_REF = {}


def _reference(key, rgla, ref_shards, **plan):
    if key not in _REF:
        _REF[key] = REN.run_query(RQuerySpec(rgla, rounds=ROUNDS, **plan), ref_shards)
    return _REF[key]


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


CASES = [(q, s) for q in ("q3", "q10") for s in ("small", "big")]


@pytest.mark.parametrize("query,size", CASES)
def test_routing_agrees_with_reference(dims, ref_shards, shards, query, size):
    """The probe-budget rule picks the same path in both packages: fused
    below the budget, the legacy K3 path above it."""
    rgla, tgla = _pair(query, size, dims)
    assert FK.probe_bytes(tgla) == RFK.probe_bytes(rgla)
    assert FK.fused_available(tgla) == RFK.fused_available(rgla) == (size == "small")
    r_path = RS.Session(RQuerySpec(rgla, rounds=ROUNDS, emit="kernel"), ref_shards)._path
    t_path = T.Session(T.QuerySpec(tgla, rounds=ROUNDS, emit="kernel"), shards,
                       device="cpu")._path
    assert t_path == r_path == ("kernel_fused" if size == "small" else "kernel_group")


@pytest.mark.parametrize("emit", ["chunk", "kernel"])
@pytest.mark.parametrize("query,size", CASES)
def test_join_matches_reference(dims, ref_shards, shards, query, size, emit):
    rgla, tgla = _pair(query, size, dims)
    want = _reference((query, size, emit), rgla, ref_shards, emit=emit)
    got = T.run_query(T.QuerySpec(tgla, rounds=ROUNDS, emit=emit), shards,
                      device="cpu")
    _assert_result(got, want)
    assert got.final.shape == (RT.NUM_SEGMENTS, 1 if query == "q3" else 4)


def test_dim_scale_matches_reference(dims, ref_shards, shards):
    """§3.3: a dimension side sampled s_dim of d_dim rows scales estimates
    by d_dim/s_dim and variances by its square."""
    for args in [(100.0, 25.0, 40.0, 10.0), (100.0, 0.0, 40.0, 40.0)]:
        np.testing.assert_allclose(TE.join_scale(*args).item(),
                                   float(RE.join_scale(*args)), rtol=1e-7)
    rgla, tgla = _pair("q3", "small", dims, d_dim=1000.0, s_dim=250.0)
    want = _reference(("q3", "small", "d_dim"), rgla, ref_shards, emit="chunk")
    got = T.run_query(T.QuerySpec(tgla, rounds=ROUNDS, emit="chunk"), shards,
                      device="cpu")
    _assert_result(got, want)
    assert got.estimates.info["dim_scale"].item() == 4.0
    plain = T.run_query(T.QuerySpec(_pair("q3", "small", dims)[1], rounds=ROUNDS,
                                    emit="chunk"), shards, device="cpu")
    torch.testing.assert_close(got.estimates.estimate, 4 * plain.estimates.estimate)


@pytest.mark.parametrize("query,size", CASES)
def test_join_oracle(raw, dims, shards, query, size):
    """The port's float64 join oracle equals the reference's, and the
    kernel path's final sits within 1e-3 of it."""
    seg, valid = dims[size]
    r_func, t_func, A = ((RT.q6_func, TT.q6_func, 1) if query == "q3"
                         else (RT.q1_func, TT.q1_func, 4))
    want = RT.exact_answer(raw, r_func, RT.q1_cond, num_groups=RT.NUM_SEGMENTS,
                           join_key=_key(size), dim_group=seg, dim_valid=valid)
    flat = {k: torch.from_numpy(v) for k, v in raw.items()}
    mine = TT.exact_answer(flat, t_func, TT.q1_cond, num_groups=TT.NUM_SEGMENTS,
                           join_key=_key(size), dim_group=torch.from_numpy(seg),
                           dim_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(mine.numpy(), want, rtol=1e-12)
    _, tgla = _pair(query, size, dims)
    got = T.run_query(T.QuerySpec(tgla, rounds=ROUNDS, emit="kernel"), shards,
                      device="cpu").final.double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    with pytest.raises(ValueError, match="dim_group and dim_valid"):
        TT.exact_answer(flat, t_func, TT.q1_cond, num_groups=5, join_key=_key(size))


def test_join_scenarios_and_dimension_tables():
    """The device-side generators draw the reference's distributions."""
    cols, g, (seg, valid) = TT.q3_scenario(40_000, device="cpu")
    assert cols["orderkey"].dtype == torch.int32 and seg.dtype == torch.int32
    assert int(cols["orderkey"].max()) < 10_000 and seg.numel() == 10_000
    assert FK.fused_available(g) and g.kernel_num_groups == TT.NUM_SEGMENTS
    r_seg, r_valid = RT.orders_table(10_000)
    np.testing.assert_allclose(valid.double().mean().item(), r_valid.mean(), rtol=0.05)
    assert set(seg.unique().tolist()) == set(np.unique(r_seg).tolist())
    _, g10, _ = TT.q10_scenario(4_000, device="cpu")
    assert g10.fused.num_aggs == 4
    nation, ok = TT.supplier_nation_table(5_000, device="cpu")
    r_nation, _ = RT.supplier_nation_table(5_000)
    assert nation.dtype == torch.int32 and bool((ok == 1).all())
    assert set(nation.unique().tolist()) == set(np.unique(r_nation).tolist())
    assert TT.NUM_NATIONS == RT.NUM_NATIONS and TT.Q3_DATE_CUTOFFS == RT.Q3_DATE_CUTOFFS
