"""Port parity for §4.6 failures on live sessions and stragglers
(``repro_torch.fault``, ``repro_torch.session.FaultPolicy``,
``engine.straggler_schedule``, ``emit="round_masked"``).

The reference's chaos sizes (8192 rows, P=4, 4 rounds, chunk_len 256): the
same numpy shards go through ``repro.core.session.Session`` and the port's
``Session`` on ``device="cpu"`` with the same ``FaultPolicy``, injected
(``fail_at``) or detected (``FailingSource``).

Tolerances: point estimates within rtol=1e-5 (finals on the scan path
1e-6), bound half-widths within 1e-3 (Eq. (4)'s cancellation, as in
test_torch_estimators.py), ``scanned``/``matched`` and every round's ±inf
pattern exactly equal, no NaN anywhere.  Within the port: rounds before the
failure bitwise the uninterrupted run, ``synchronized`` frozen at the last
pre-failure round, ``multiple`` poisoned from the failure round on, and a
streamed failure bitwise the resident session injected with the round it
recorded.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as T
from repro.core import engine as RE
from repro.core import gla as RG
from repro.core import randomize as RR
from repro.core import session as RS
from repro.core.spec import QuerySpec as RQuerySpec
from repro.data import tpch as RT
from repro.dist import fault as RF
from repro_torch import engine as TEN
from repro_torch import fault as TF
from repro_torch import session as TS
from repro_torch.data import source as TD
from repro_torch.data import tpch as TT
from repro_torch.uda import Estimate, tree_map

ROWS, P, ROUNDS, L = 8192, 4, 4, 256  # C = 8: two chunks a round
FAIL_ROUNDS = (0, 2, 3)
EST_RTOL, HALF_RTOL, SCAN_RTOL = 1e-5, 1e-3, 1e-6


@pytest.fixture(scope="module")
def shards():
    raw = RT.generate_lineitem(ROWS, seed=21)
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in raw.items()},
                                jax.random.key(4), P)
    ref = RR.pack_partitions(parts, chunk_len=L)
    return ref, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}


def _sum(pkg, estimator, window=(0, 1460)):
    if pkg == "ref":
        def cond(c):
            sd = c["shipdate"]
            return ((sd >= window[0]) & (sd < window[1])).astype(jnp.float32)

        return RG.make_sum_gla(lambda c: c["quantity"], cond,
                               d_total=float(ROWS), estimator=estimator)

    def cond_t(c):
        sd = c["shipdate"]
        return ((sd >= window[0]) & (sd < window[1])).to(torch.float32)

    return T.make_sum_gla(lambda c: c["quantity"], cond_t, d_total=float(ROWS),
                          estimator=estimator)


def _group(pkg, estimator):
    if pkg == "ref":
        return RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_small,
                                   num_groups=4, d_total=float(ROWS), num_aggs=4,
                                   estimator=estimator)
    return T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small,
                              num_groups=4, d_total=float(ROWS), num_aggs=4,
                              estimator=estimator)


def _bundle(pkg, estimator):
    mk = RG.GLABundle if pkg == "ref" else T.GLABundle
    return mk([_sum(pkg, estimator), _sum(pkg, estimator, window=(0, 400))])


_BUILD = {"scan": _sum, "kernel_group": _group, "kernel_bundle": _bundle}
# the multiple model's MultState has no kernel contract: kernels run the
# SumState families, as in the reference's matrix
CASES = ([("scan", e) for e in ("single", "multiple", "synchronized")]
         + [(p, e) for p in ("kernel_group", "kernel_bundle")
            for e in ("single", "synchronized")])
_GLAS = {}


def _gla(pkg, path, estimator):
    key = (pkg, path, estimator)
    if key not in _GLAS:  # one GLA per cell: the reference jits on it
        _GLAS[key] = _BUILD[path](pkg, estimator)
    return _GLAS[key]


def _drive(sess):
    while not sess.done:
        sess.step()
    return sess.result()


def _members(est):
    return (est,) if isinstance(est, (Estimate, RS.Estimate)) else tuple(
        e for e in est if e is not None)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _no_nan(res):
    for part in (res.final, res.snapshots, res.estimates):
        for leaf in _leaves(part):
            assert not torch.isnan(leaf).any()


def _close(a, b, rtol):
    a, b = _np(a), _np(b)
    assert np.array_equal(np.isposinf(a), np.isposinf(b))
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(b)
    atol = rtol * max(np.abs(b[fin]).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=atol)


def _assert_estimates(got, want):
    for eg, ew in zip(_members(got), _members(want), strict=True):
        _close(eg.estimate, ew.estimate, EST_RTOL)
        _close(eg.lower, ew.lower, np.inf)  # the ±inf pattern only
        _close(eg.upper, ew.upper, np.inf)
        _close((_np(eg.upper) - _np(eg.lower)) / 2,
               (_np(ew.upper) - _np(ew.lower)) / 2, HALF_RTOL)


def _assert_counters(got_snaps, want_snaps):
    for g, w in zip(_members_states(got_snaps), _members_states(want_snaps), strict=True):
        base_g, base_w = getattr(g, "base", g), getattr(w, "base", w)
        np.testing.assert_array_equal(base_g.scanned.numpy(), np.asarray(base_w.scanned))
        np.testing.assert_array_equal(base_g.matched.numpy(), np.asarray(base_w.matched))


def _members_states(snaps):
    return snaps if isinstance(snaps, tuple) and not hasattr(snaps, "_fields") else (snaps,)


def _rows(est):
    return _np(est.estimate), _np(est.lower), _np(est.upper)


def _check_single(em, eb, fr):
    x, lo, hi = _rows(em)
    _, lob, hib = _rows(eb)
    assert np.isfinite(lo).all() and np.isfinite(hi).all() and np.isfinite(x).all()
    np.testing.assert_array_equal(lo[:fr], lob[:fr])
    np.testing.assert_array_equal(hi[:fr], hib[:fr])
    assert np.max(hi[-1] - lo[-1]) > np.max(hib[-1] - lob[-1])  # the floor


def _check_multiple(em, eb, fr):
    x, lo, hi = _rows(em)
    _, lob, hib = _rows(eb)
    assert np.isneginf(lo[fr:]).all() and np.isposinf(hi[fr:]).all()
    np.testing.assert_array_equal(lo[:fr], lob[:fr])
    np.testing.assert_array_equal(hi[:fr], hib[:fr])


def _check_sync(em, eb, fr):
    x, lo, hi = _rows(em)
    xb, lob, hib = _rows(eb)
    if fr == 0:
        assert np.isneginf(lo).all() and np.isposinf(hi).all()
        return
    for a, b in ((x, xb), (lo, lob), (hi, hib)):
        np.testing.assert_array_equal(a[:fr], b[:fr])
        for r in range(fr, a.shape[0]):
            np.testing.assert_array_equal(a[r], a[fr - 1])


_CHECKS = {"single": _check_single, "multiple": _check_multiple,
           "synchronized": _check_sync}


@pytest.fixture(scope="module")
def baselines(shards):
    _, t_shards = shards
    out = {}
    for path, est in CASES:
        emit = "chunk" if path == "scan" else "kernel"
        out[(path, est)] = _drive(T.Session(
            T.QuerySpec(_gla("port", path, est), rounds=ROUNDS, emit=emit),
            t_shards, device="cpu"))
    return out


@pytest.mark.parametrize("fail_round", FAIL_ROUNDS)
@pytest.mark.parametrize("path,estimator", CASES)
def test_kill_at_round_matches_reference(shards, baselines, path, estimator,
                                         fail_round):
    ref_shards, t_shards = shards
    emit = "chunk" if path == "scan" else "kernel"
    ref = _drive(RS.Session(
        _gla("ref", path, estimator), ref_shards, rounds=ROUNDS, emit=emit,
        fault=RS.FaultPolicy(estimator, fail_at={2: fail_round})))
    sess = T.Session(T.QuerySpec(
        _gla("port", path, estimator), rounds=ROUNDS, emit=emit,
        fault=T.FaultPolicy(estimator, fail_at={2: fail_round})), t_shards,
        device="cpu")
    res = _drive(sess)
    _no_nan(res)
    _assert_estimates(res.estimates, ref.estimates)
    _assert_counters(res.snapshots, ref.snapshots)
    for a, b in zip(_leaves(res.final), jax.tree.leaves(ref.final), strict=True):
        _close(a, b, SCAN_RTOL if path == "scan" else EST_RTOL)
    for em, eb in zip(_members(res.estimates),
                      _members(baselines[(path, estimator)].estimates), strict=True):
        _CHECKS[estimator](em, eb, fail_round)


def test_final_covers_surviving_data_only(shards):
    """The live final equals the whole-scan run_with_failures final, and
    the reference's: the dead partition's data is excluded."""
    ref_shards, t_shards = shards
    g = _gla("port", "scan", "single")
    res = _drive(T.Session(T.QuerySpec(g, rounds=ROUNDS, fault=T.FaultPolicy(
        "single", fail_at={2: 2})), t_shards, device="cpu"))
    whole = TF.run_with_failures(g, t_shards, rounds=ROUNDS, fail_at={2: 2},
                                 device="cpu")
    ref = RF.run_with_failures(_gla("ref", "scan", "single"), ref_shards,
                               rounds=ROUNDS, fail_at={2: 2})
    _close(res.final, whole.final, SCAN_RTOL)
    _close(res.final, ref.final, SCAN_RTOL)


@pytest.mark.parametrize("estimator", ["single", "multiple", "synchronized"])
def test_whole_scan_policy_matches_run_with_failures(shards, estimator):
    """run() with no stopping rule runs the whole-scan program: the policy
    ships as an [R, P] schedule and is post-processed as
    run_with_failures does, in the port and in the reference."""
    ref_shards, t_shards = shards
    g = _gla("port", "scan", estimator)
    a = T.Session(T.QuerySpec(g, rounds=ROUNDS, fault=T.FaultPolicy(
        estimator, fail_at={1: 2})), t_shards, device="cpu").run()
    b = TF.run_with_failures(g, t_shards, rounds=ROUNDS, fail_at={1: 2},
                             estimator=estimator, device="cpu")
    assert torch.equal(a.estimates.lower, b.estimates.lower)
    assert torch.equal(a.estimates.upper, b.estimates.upper)
    assert torch.equal(a.final, b.final)
    ref = RF.run_with_failures(_gla("ref", "scan", estimator), ref_shards,
                               rounds=ROUNDS, fail_at={1: 2}, estimator=estimator)
    _assert_estimates(b.estimates, ref.estimates)


def test_run_with_failures_and_variance_floor_match_reference(shards):
    ref_shards, t_shards = shards
    g, rg = _gla("port", "scan", "single"), _gla("ref", "scan", "single")
    got = TF.run_with_failures(g, t_shards, dead_partitions=[2], device="cpu")
    want = RF.run_with_failures(rg, ref_shards, dead_partitions=[2])
    _assert_estimates(got.estimates, want.estimates)
    _close(got.final, want.final, SCAN_RTOL)
    floor = TF.variance_floor(g, t_shards, [2], device="cpu")
    assert floor > 0.0
    np.testing.assert_allclose(floor, RF.variance_floor(rg, ref_shards, [2]),
                               rtol=HALF_RTOL)
    assert TF.variance_floor(g, t_shards, [], device="cpu") == 0.0
    gm = _gla("port", "scan", "multiple")
    mult = TF.run_with_failures(gm, t_shards, dead_partitions=[1],
                                estimator="multiple", device="cpu")
    assert torch.isneginf(mult.estimates.lower).all()
    assert torch.isposinf(mult.estimates.upper).all()


# ---------------------------------------------------------------------------
# detection: a streamed read loses partitions for real
# ---------------------------------------------------------------------------

def test_streaming_loss_recorded_at_the_reference_round(shards):
    """FailingSource raises PartitionLostError from the prefetcher's
    worker thread; the port records the same round as the reference and
    finishes bitwise the resident session injected with it."""
    ref_shards, t_shards = shards
    rsess = RS.Session(_gla("ref", "scan", "single"),
                       RF.FailingSource(ref_shards, fail_chunk={2: 4}),
                       rounds=ROUNDS, fault=RS.FaultPolicy("single"))
    ref = _drive(rsess)
    g = _gla("port", "scan", "single")
    sess = T.Session(T.QuerySpec(g, rounds=ROUNDS, fault=T.FaultPolicy("single")),
                     TF.FailingSource(t_shards, fail_chunk={2: 4}), device="cpu")
    res = _drive(sess)
    assert sess._fail_at == rsess._fail_at == {2: 2}
    _no_nan(res)
    _assert_estimates(res.estimates, ref.estimates)
    inj = _drive(T.Session(T.QuerySpec(g, rounds=ROUNDS, fault=T.FaultPolicy(
        "single", fail_at={2: 2})), t_shards, device="cpu"))
    for a, b in zip(_leaves((res.final, res.estimates)),
                    _leaves((inj.final, inj.estimates)), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("attempt", range(3))
def test_two_partitions_lost_in_consecutive_rounds(shards, attempt):
    """Partition 1 dies in round 2's read and partition 2 in round 3's,
    which the prefetcher may already be reading when round 2 fails.  Both
    losses are recorded (at the round whose data first misses them), and
    the run is bitwise the resident session injected with that record —
    no partition's data zeroed while its merge weight stays 1."""
    _, t_shards = shards
    g = _gla("port", "kernel_group", "single")
    sess = T.Session(T.QuerySpec(g, rounds=ROUNDS, emit="kernel",
                                 fault=T.FaultPolicy("single")),
                     TF.FailingSource(t_shards, fail_chunk={1: 4, 2: 6}),
                     device="cpu")
    res = _drive(sess)
    assert sess._fail_at[1] == 2 and sess._fail_at.get(2) in (2, 3)
    inj = _drive(T.Session(T.QuerySpec(g, rounds=ROUNDS, emit="kernel",
                                       fault=T.FaultPolicy("single",
                                                           fail_at=sess._fail_at)),
                           t_shards, device="cpu"))
    for a, b in zip(_leaves((res.final, res.snapshots, res.estimates)),
                    _leaves((inj.final, inj.snapshots, inj.estimates)), strict=True):
        assert torch.equal(a, b)


class _GatedSource(TD.ChunkSource):
    """Round 2's read fails only after round 3's read has failed too."""

    def __init__(self, inner):
        self.inner, self.spec = inner, inner.spec
        self.r3_failed = threading.Event()

    def slice_cols(self, lo, hi):
        if lo == 4:
            assert self.r3_failed.wait(10)
            raise TD.PartitionLostError([1])
        if lo == 6:
            self.r3_failed.set()
            raise TD.PartitionLostError([2])
        return self.inner.slice_cols(lo, hi)


def test_prefetcher_reports_the_loss_of_the_fetch_in_flight(shards):
    """The fetch of round r+1 scheduled before round r's read failed is
    drained, and its loss joins round r's error instead of being dropped
    with its future."""
    from concurrent.futures import ThreadPoolExecutor

    _, t_shards = shards
    src = _GatedSource(TD.InMemorySource(t_shards))
    pf = TS._SlicePrefetcher(src, [(0, 2), (2, 4), (4, 6), (6, 8)],
                             torch.device("cpu"))
    pf._ex.shutdown()
    pf._ex = ThreadPoolExecutor(max_workers=2)  # both reads in flight at once
    pf.get(1)
    with pytest.raises(TD.PartitionLostError) as err:
        pf.get(2)
    assert err.value.partitions == (1, 2)
    assert pf._fut is None
    pf.close()


def test_streaming_loss_without_policy_is_fatal(shards):
    _, t_shards = shards
    sess = T.Session(T.QuerySpec(_gla("port", "scan", "single"), rounds=ROUNDS),
                     TF.FailingSource(t_shards, fail_chunk={1: 0}), device="cpu")
    with pytest.raises(TF.PartitionLostError, match=r"\[1\]"):
        sess.step()


def test_policy_api_validation(shards):
    _, t_shards = shards
    g = _gla("port", "scan", "single")
    with pytest.raises(ValueError, match="unknown estimator model"):
        T.FaultPolicy("stratified")
    with pytest.raises(ValueError, match=">= 0"):
        T.FaultPolicy("single", fail_at={0: -1})
    with pytest.raises(ValueError, match="P=4"):
        T.Session(T.QuerySpec(g, fault=T.FaultPolicy("single", fail_at={7: 1})),
                  t_shards, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        T.Session(T.QuerySpec(g, alive=np.ones(P, bool), fault=T.FaultPolicy()),
                  t_shards, device="cpu")
    with pytest.raises(ValueError, match="P="):
        TF.FailingSource(t_shards, fail_chunk={9: 0})
    with pytest.raises(ValueError, match="not both"):
        T.QuerySpec(g, fault=T.FaultPolicy(), estimator_merge="single")
    spec = T.QuerySpec(g, estimator_merge="multiple")
    assert spec.resolved_fault().estimator == "multiple"
    assert T.QuerySpec(g).resolved_fault() is None


def test_failure_helpers_equal_reference():
    np.testing.assert_array_equal(TF.alive_mask(5, [1, 3]), RF.alive_mask(5, [1, 3]))
    at = {0: 2, 3: 0}
    np.testing.assert_array_equal(TF.failure_schedule(4, 5, at),
                                  RF.failure_schedule(4, 5, at))
    for alive in (np.ones(4, bool), RF.alive_mask(4, [2]),
                  RF.failure_schedule(4, 5, at), RF.failure_schedule(4, 5, {})):
        assert TF.first_failure_round(alive) == RF.first_failure_round(alive)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    e_t = Estimate(torch.from_numpy(x), torch.from_numpy(x - 1), torch.from_numpy(x + 1))
    e_r = RS.Estimate(jnp.asarray(x), jnp.asarray(x - 1), jnp.asarray(x + 1))
    for fn_t, fn_r in ((TF._poison, RF._poison), (TF._stall, RF._stall)):
        for fr in (0, 2, 5):
            got, want = fn_t(e_t, fr), fn_r(e_r, fr)
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_straggler_schedule_equals_reference(seed):
    speeds = [1, 1, 0.5, 0.25]
    np.testing.assert_array_equal(
        TEN.straggler_schedule(4, 37, 6, speeds, seed=seed),
        RE.straggler_schedule(4, 37, 6, speeds, seed=seed))


def _q1_pair(estimator="single"):
    return _gla("ref", "kernel_group", estimator), _gla("port", "kernel_group", estimator)


@pytest.mark.parametrize("case", ["round_masked/q1", "round_masked/multiple",
                                  "sync/chunk", "async/kernel"])
def test_straggler_runs_match_reference(shards, case):
    """A straggler schedule on emit="round_masked" (any schedule, states at
    round boundaries), the synchronized barrier on emit="chunk" and the
    scalar kernel (K2) prefixes, each against the reference."""
    ref_shards, t_shards = shards
    C = ROWS // P // L
    sched = RE.straggler_schedule(P, C, ROUNDS, [1, 1, 1, 0.25], seed=1)
    mode, emit = case.split("/")
    if case == "round_masked/q1":
        rg, tg = _q1_pair()
        mode, emit = "async", "round_masked"
    elif case == "round_masked/multiple":
        rg, tg = _gla("ref", "scan", "multiple"), _gla("port", "scan", "multiple")
        mode, emit = "async", "round_masked"
    else:
        rg, tg = _gla("ref", "scan", "single"), _gla("port", "scan", "single")
    ref = RE.run_query(RQuerySpec(rg, schedule=sched, sync=mode == "sync", emit=emit),
                       ref_shards)
    got = T.run_query(T.QuerySpec(tg, schedule=sched, sync=mode == "sync", emit=emit),
                      t_shards, device="cpu")
    _assert_estimates(got.estimates, ref.estimates)
    _assert_counters(got.snapshots, ref.snapshots)
    for a, b in zip(_leaves(got.final), jax.tree.leaves(ref.final), strict=True):
        _close(a, b, SCAN_RTOL if emit != "kernel" else EST_RTOL)


def test_round_masked_uniform_schedule_equals_round_emission(shards):
    """Under a uniform schedule round_masked folds the same chunks in the
    same order as emit="round": bitwise."""
    _, t_shards = shards
    g = _gla("port", "kernel_group", "single")
    a = T.run_query(T.QuerySpec(g, rounds=ROUNDS, emit="round_masked"), t_shards,
                    device="cpu")
    b = T.run_query(T.QuerySpec(g, rounds=ROUNDS, emit="round"), t_shards,
                    device="cpu")
    for x, y in zip(_leaves((a.final, a.snapshots, a.estimates)),
                    _leaves((b.final, b.snapshots, b.estimates)), strict=True):
        assert torch.equal(x, y)


def test_non_uniform_schedule_names_round_masked(shards):
    _, t_shards = shards
    sched = RE.straggler_schedule(P, 8, ROUNDS, [1, 1, 1, 0.25])
    with pytest.raises(ValueError, match="round_masked"):
        T.run_query(T.QuerySpec(_gla("port", "kernel_group", "single"),
                                schedule=sched, emit="round"), t_shards, device="cpu")
