"""Port parity for concurrent serving (``repro_torch.service``, the slot
families of ``repro_torch.gla``) against ``repro/serving/service.py``.

The same numpy shards go into both packages, at the reference test's size
(8,192 rows, P=4, L=128, 8 rounds) and with its family.  A late-joining
scalar, group or HAVING slot of the port's ``SharedScan`` is bitwise the
port's solo ``Session(emit="kernel")`` over the ranges it witnessed, and
within the engine tests' tolerances of the reference's ``SharedScan``:
counters exact, f32 estimates rtol 1e-5 with atol 1e-5·max|ref|,
half-widths rtol 1e-3.  Also: slot reclaim from +0.0 with no new step
plan, plans bounded by capacity doublings under churn, the witnessed
coverage property, the asyncio service, the nested HAVING estimate's ±inf
rule, encoded and npy sources bitwise the resident scan (the reference
raises on the encoded one), two gloo ranks bitwise one process, and the
serving CLI.
"""
import asyncio
import functools
import multiprocessing
import pickle
import time
import traceback
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch as T
from repro.core import estimators as RE
from repro.core import gla as RG
from repro.core import randomize as RR
from repro.core.spec import QuerySpec as RQuerySpec
from repro.core.uda import Estimate as REstimate
from repro.data import encodings as REnc
from repro.data import source as RD
from repro.data import tpch as RT
from repro.serving import service as RSV
from repro_torch import convert
from repro_torch import estimators as TE
from repro_torch import serve as TCLI
from repro_torch import service as SV
from repro_torch import sharded as SH
from repro_torch.data import source as TD
from repro_torch.data import tpch as TT
from repro_torch.kernels import fused_agg as TFA

ROWS, PARTS, CHUNK, ROUNDS = 8192, 4, 128, 8
RTOL, HALF_RTOL = 1e-5, 1e-3
JOIN_S = 120.0  # seconds the spawned ranks may take in all
TIMEOUT = 60.0  # seconds a rank waits in a collective


@functools.lru_cache(maxsize=None)
def _packed(parts=PARTS):
    """The reference test's shards, as numpy arrays."""
    cols = RT.generate_lineitem(ROWS, seed=1)
    data = {k: jnp.asarray(v) for k, v in cols.items()}
    shards = RR.randomize_global(data, jax.random.key(9), parts)
    return {k: np.asarray(v) for k, v in RR.pack_partitions(shards, chunk_len=CHUNK).items()}


def _shards():
    return convert.shards_from_reference(_packed(), device="cpu")


def _family():
    return T.SlotFamily(
        exprs={"q6": TT.q6_func, "qty": lambda c: c["quantity"]},
        pred_cols=("shipdate", "discount"),
        groups={"rfls": (TT.q1_group_small, 4)})


@functools.lru_cache(maxsize=None)
def _ref_family():
    return RG.SlotFamily(
        exprs={"q6": RT.q6_func, "qty": lambda c: c["quantity"]},
        pred_cols=("shipdate", "discount"),
        groups={"rfls": (RT.q1_group_small, 4)})


Q_SCALAR = T.SlotQuery("q6", {"shipdate": (420.0, 785.0)})
Q_LATE = T.SlotQuery("qty", {"discount": (0.02, 0.08)})
Q_GROUP = T.SlotQuery("q6", {"shipdate": (100.0, 2000.0)}, group="rfls")
Q_HAVING_BASE = T.SlotQuery("qty", {"shipdate": (0.0, 1500.0)}, group="rfls")
JOIN_AT, LATE_STEPS = 3, 4  # the late joiner witnesses rounds 3..6


def _having_query():
    """Q_HAVING_BASE with a HAVING threshold halfway between the second and
    third of the four group estimates the late joiner ends with (computed
    in float64 from the rounds it will witness), so that two groups pass
    and two do not."""
    p = _packed()
    w = p["_mask"].shape[1] // ROUNDS
    win = {k: v[:, JOIN_AT * w:(JOIN_AT + LATE_STEPS) * w].reshape(-1) for k, v in p.items()}
    live = win["_mask"] > 0
    keep = live & (win["shipdate"] >= 0) & (win["shipdate"] < 1500)
    sums = np.bincount(win["rfls"][keep], weights=win["quantity"][keep].astype(np.float64),
                       minlength=4)
    est = np.sort(float(p["_mask"].sum()) / float(live.sum()) * sums)
    return Q_HAVING_BASE._replace(having=float((est[1] + est[2]) / 2))


def _ref_query(q):
    return RG.SlotQuery(q.expr, dict(q.ranges), q.group, q.having)


def _bits(a, b):
    return a.detach().numpy().tobytes() == b.detach().numpy().tobytes()


def _same_estimate(a, b):
    return all(_bits(x, y) for x, y in zip(a[:3], b[:3]))


def _close(got, want, rtol, what):
    a = got.detach().numpy().astype(np.float64)
    b = np.asarray(want, np.float64)
    assert a.shape == b.shape, what
    assert not np.isnan(a).any(), what
    assert np.array_equal(np.isinf(a), np.isinf(b)), what
    fin = np.isfinite(b)
    atol = rtol * np.abs(b[fin]).max(initial=0.0)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=atol, err_msg=what)


def _solo(family, data, rec, d_total, **kw):
    """The port's fresh solo Session over exactly the ranges ``rec``
    witnessed, stepped to its end: its last Estimate."""
    view = SV.witnessed_view(data, rec.witnessed)
    sess = T.Session(T.QuerySpec(family.solo_gla(rec.query, d_total=d_total),
                                 rounds=len(rec.witnessed), emit="kernel"),
                     view, device="cpu", **kw)
    prog = None
    while not sess.done:
        prog = sess.step()
    return prog.estimates


def _late_join(scan, early, late):
    r1 = scan.attach(early)
    for _ in range(JOIN_AT):
        scan.step()
    r2 = scan.attach(late)
    for _ in range(LATE_STEPS):
        scan.step()
    return r1, r2


# ---------------------------------------------------------------------------
# the synchronous core
# ---------------------------------------------------------------------------

def test_degrade_rounds_matches_reference():
    assert SV._degrade_rounds(16, 8) == 8
    assert SV._degrade_rounds(12, 8) == 6
    assert SV._degrade_rounds(7, 8) == 7
    assert SV._degrade_rounds(7, 4) == 1
    for C in range(1, 40):
        for r in range(1, 12):
            assert SV._degrade_rounds(C, r) == RSV._degrade_rounds(C, r), (C, r)


@pytest.mark.parametrize("kind", ["scalar", "group", "having"])
def test_late_join_bitwise_solo_and_close_to_reference(kind):
    late = {"scalar": Q_LATE, "group": Q_GROUP, "having": _having_query()}[kind]
    fam, shards = _family(), _shards()
    scan = SV.SharedScan(fam, shards, rounds=ROUNDS, device="cpu")
    r1, r2 = _late_join(scan, Q_SCALAR, late)
    assert [lo for lo, _ in r2.witnessed] == [c * scan.width for c in range(3, 7)]
    assert scan.banks[fam.bank_of(late)].plans[1].path == "kernel_fused"
    solo = _solo(fam, shards, r2, scan.d_total)
    assert _same_estimate(r2.estimate, solo), kind
    if kind == "having":  # the threshold splits the groups
        keep = r2.estimate.info["keep"].reshape(-1)
        assert keep.min() == 0 and keep.max() == 1

    ref = RSV.SharedScan(_ref_family(), {k: jnp.asarray(v) for k, v in _packed().items()},
                         rounds=ROUNDS)
    q1, q2 = _late_join(ref, _ref_query(Q_SCALAR), _ref_query(late))
    assert r2.witnessed == q2.witnessed and r1.witnessed == q1.witnessed
    assert r2.scanned == q2.scanned and r1.scanned == q1.scanned
    assert scan.d_total == float(np.asarray(ref._d_total))
    for got, want in ((r1.estimate, q1.estimate), (r2.estimate, q2.estimate)):
        _close(got.estimate, want.estimate, RTOL, f"{kind} estimate")
        _close((got.upper - got.lower) / 2,
               (np.asarray(want.upper) - np.asarray(want.lower)) / 2, HALF_RTOL,
               f"{kind} half-width")
    if kind == "group":
        np.testing.assert_array_equal(r2.estimate.info["matched"].numpy(),
                                      np.asarray(q2.estimate.info["matched"]))
    if kind == "having":
        np.testing.assert_array_equal(r2.estimate.info["keep"].numpy(),
                                      np.asarray(q2.estimate.info["keep"]))
    # the early joiner completes its full pass one step later
    scan.step()
    assert r1.done and not r1.converged
    assert len(r1.witnessed) == scan.rounds and r1.scanned == scan.d_total


def test_bank_steps_one_bundle_launch_per_16_slots(monkeypatch):
    """A bank of K slots is one K-member K1 bundle: ceil(K/16) pf_bundle
    launches a step (counted at the wrapper: the CPU runs the plain
    version), the basis expression evaluated once for all of them."""
    calls, evals = [], []
    real = TFA.bundle_round_step
    monkeypatch.setattr(TFA, "bundle_round_step",
                        lambda members: calls.append(len(members)) or real(members))

    def qty(c):
        evals.append(1)
        return c["quantity"]

    fam = T.SlotFamily(exprs={"qty": qty}, pred_cols=("discount",))
    scan = SV.SharedScan(fam, _shards(), rounds=ROUNDS, device="cpu")
    for i in range(20):
        scan.attach(T.SlotQuery("qty", {"discount": (0.0, 0.01 * (i + 1))}))
    scan.step()
    assert scan.banks["scalar"].K == 32 and calls == [32]
    assert len(evals) == 1  # one value column for 32 slots
    assert -(-calls[0] // TFA.MAX_BUNDLE_MEMBERS) == 2


def test_group_bank_evaluates_its_key_once_for_every_slot(monkeypatch):
    """A group bank's K slots share one evaluation of the group key a step:
    every member hands the kernel the same int32 ids tensor, not K copies,
    and each slot stays bitwise its solo session."""
    members, keys = [], []
    real = TFA.bundle_round_step
    monkeypatch.setattr(TFA, "bundle_round_step",
                        lambda ms: members.append(ms) or real(ms))

    def rfls(c):
        keys.append(1)
        return TT.q1_group_small(c)

    fam = T.SlotFamily(exprs={"q6": TT.q6_func, "qty": lambda c: c["quantity"]},
                       pred_cols=("shipdate", "discount"), groups={"rfls": (rfls, 4)})
    shards = _shards()
    scan = SV.SharedScan(fam, shards, rounds=ROUNDS, device="cpu")
    recs = [scan.attach(T.SlotQuery(["q6", "qty"][i % 2], {"shipdate": (100.0 * i, 2400.0)},
                                    group="rfls")) for i in range(5)]
    for _ in range(2):
        scan.step()
    assert scan.banks["rfls"].K == 8 and len(keys) == 2  # once a step
    for ms in members:
        assert len(ms) == 8 and all(m[2] is ms[0][2] for m in ms)
        assert ms[0][2].dtype == torch.int32 and ms[0][2].is_contiguous()
    for rec in recs[::2]:
        assert _same_estimate(rec.estimate, _solo(fam, shards, rec, scan.d_total))


def _neg_family():
    return T.SlotFamily(exprs={"neg": lambda c: -c["quantity"]},
                        pred_cols=("shipdate", "discount"))


def test_detach_reattach_reuses_slot_from_positive_zero():
    fam, shards = _neg_family(), _shards()
    scan = SV.SharedScan(fam, shards, rounds=ROUNDS, device="cpu")
    recs = [scan.attach(T.SlotQuery("neg", {"discount": (0.0, 0.02 + i / 100)}))
            for i in range(3)]
    scan.step()
    bank = scan.banks["scalar"]
    k0, plans0 = bank.K, SV.serve_step_cache_sizes()
    victim = recs[1]
    carry = bank.states[victim.slot]
    assert bool((carry.sum < 0).all())
    # masking the carry by multiplication would leave -0.0 here
    assert bool(torch.signbit(carry.sum * 0.0).all())
    scan.detach(victim)
    renew = scan.attach(T.SlotQuery("neg", {"shipdate": (0.0, 900.0)}))
    assert renew.slot == victim.slot  # the freed slot, reclaimed...
    assert renew.generation == victim.generation + 1  # ...at a new generation
    _, states, _ = scan.step_inputs("scalar")
    for x in states[renew.slot]:
        assert bool((x == 0).all()) and not bool(torch.signbit(x).any())
    scan.step()
    assert bank.K == k0 and sorted(bank.plans) == [k0]
    assert SV.serve_step_cache_sizes() == plans0  # no new plan
    solo = _solo(fam, shards, renew, scan.d_total)
    assert _same_estimate(renew.estimate, solo)
    assert _same_estimate(recs[0].estimate, _solo(fam, shards, recs[0], scan.d_total))


def test_churn_builds_plans_only_on_capacity_doublings():
    fam, shards = _family(), _shards()
    scan = SV.SharedScan(fam, shards, rounds=4, device="cpu")
    before = SV.serve_step_cache_sizes()
    rng = np.random.default_rng(3)
    live, arrivals = [], 0
    for step in range(12):
        for _ in range(int(rng.integers(1, 5))):
            lo = float(rng.integers(0, 2000))
            q = T.SlotQuery(["q6", "qty"][arrivals % 2], {"shipdate": (lo, lo + 400.0)},
                            group="rfls" if arrivals % 5 == 4 else None)
            live.append(scan.attach(q))
            arrivals += 1
        for rec in [r for r in live if rng.random() < 0.3]:
            scan.detach(rec)
            live.remove(rec)
        for rec, _ in scan.step():
            if rec.done:
                scan.detach(rec)
                live.remove(rec)
    built = SV.serve_step_cache_sizes() - before
    budget = scan.compile_budget()
    for bank in scan.banks.values():
        assert len(bank.plans) <= 1 + bank.doublings, bank.name
        assert set(bank.plans) <= {1 << i for i in range(bank.doublings + 1)}, bank.name
    assert built == budget
    assert scan.banks["scalar"].doublings >= 1
    assert arrivals > budget


@settings(max_examples=8, deadline=None, database=None)
@given(st.integers(min_value=0, max_value=6), st.integers(min_value=1, max_value=8),
       st.floats(min_value=0.0, max_value=1200.0))
def test_witnessed_coverage_never_below_reported_scanned(join, steps, lo):
    """Whatever round a query joins at and however long it runs, the live
    rows inside its witnessed ranges are exactly what the scan reports as
    scanned: the scale-up ``d_total / scanned`` never overstates coverage."""
    fam = _family()
    scan = SV.SharedScan(fam, _shards(), rounds=ROUNDS, device="cpu")
    warm = scan.attach(Q_SCALAR)  # keeps the scan advancing
    for _ in range(join):
        scan.step()
        if warm.done:
            scan.detach(warm)
            warm = scan.attach(Q_SCALAR)
    rec = scan.attach(T.SlotQuery("qty", {"shipdate": (lo, lo + 365.0)}))
    for _ in range(steps):
        scan.step()
    covered = sum(float(scan._ms[:, a:b].sum()) for a, b in rec.witnessed)
    assert len(rec.witnessed) == steps
    assert covered == rec.scanned
    assert rec.scanned <= steps * scan.d_total


def test_nested_group_estimate_poisons_to_infinite_bounds_not_nan():
    """A passing group with |S| <= 1 (+inf inner variance) gives ±inf outer
    bounds and a finite estimate; a failing one leaves the bounds finite.
    Both as the reference's."""
    est = np.array([[5.0], [7.0], [1.0]], np.float32)
    var = np.array([[np.inf], [4.0], [np.inf]], np.float32)
    inner_t = T.Estimate(torch.from_numpy(est), torch.from_numpy(est),
                         torch.from_numpy(est), info={"var": torch.from_numpy(var)})
    inner_r = REstimate(jnp.asarray(est), jnp.asarray(est), jnp.asarray(est),
                        info={"var": jnp.asarray(var)})
    for thr, finite in ((4.0, False), (6.0, True)):
        got = TE.nested_group_estimate(inner_t, lambda v, t=thr: v[..., 0] >= t, 0.95)
        want = RE.nested_group_estimate(inner_r, lambda v, t=thr: v[:, 0] >= t, 0.95)
        np.testing.assert_array_equal(got.estimate.numpy(), np.asarray(want.estimate))
        for a, b in zip(got[1:3], want[1:3]):  # the z quantiles differ in the last bit
            assert not torch.isnan(a).any()
            _close(a, b, RTOL, "bound")
        assert torch.isfinite(got.estimate).all()
        assert bool(torch.isfinite(got.lower).all()) == finite
        if not finite:
            assert got.lower.item() == -np.inf and got.upper.item() == np.inf
    with pytest.raises(ValueError):
        T.make_having_gla(T.make_groupby_gla(TT.q6_func, TT.q1_cond, TT.q1_group_small,
                                             num_groups=4, d_total=1.0), 1.0, mode="!=")
    with pytest.raises(ValueError):
        T.compose(T.GLABundle([T.make_sum_gla(TT.q6_func, TT.q1_cond, d_total=1.0)]),
                  lambda e, c: e)


def test_having_gla_rides_k1_group_with_a_tensor_threshold():
    """compose keeps the inner GLA's scaffolding: the HAVING GLA publishes
    the group's fused contract, and a 0-d tensor threshold gives the bits of
    the host float."""
    inner = T.make_groupby_gla(TT.q6_func, TT.q1_cond, TT.q1_group_small,
                               num_groups=4, d_total=float(ROWS))
    h_float = T.make_having_gla(inner, 10.0)
    h_tensor = T.make_having_gla(inner, torch.tensor(10.0))
    assert h_float.fused is inner.fused and h_float.init is inner.init
    shards = _shards()
    res = [T.run_query(T.QuerySpec(g, rounds=4, emit="kernel"), shards, device="cpu")
           for g in (h_float, h_tensor)]
    assert _same_estimate(res[0].estimates, res[1].estimates)


# ---------------------------------------------------------------------------
# sources: the encoded copy is decoded (the reference raises on it)
# ---------------------------------------------------------------------------

def _encodings():
    p = _packed()
    return {"discount": REnc.dict_encoding_for(p["discount"]),
            "quantity": REnc.dict_encoding_for(p["quantity"]),
            "tax": REnc.dict_encoding_for(p["tax"]),
            "shipdate": REnc.BitPackedEncoding(16), "rfls": REnc.BitPackedEncoding(2)}


def _serve_schedule(scan):
    """The late-join schedule with a scalar, a group and a HAVING joiner;
    every slot's estimate after each step."""
    recs = [scan.attach(Q_SCALAR)]
    out = []
    for i in range(ROUNDS):
        if i == JOIN_AT:
            recs += [scan.attach(q) for q in (Q_LATE, Q_GROUP, _having_query())]
        scan.step()
        out.append([(r.estimate, r.scanned, list(r.witnessed)) for r in recs])
    return out


def _same_run(a, b):
    return all(len(x) == len(y) and all(
        _same_estimate(e1, e2) and s1 == s2 and w1 == w2
        for (e1, s1, w1), (e2, s2, w2) in zip(x, y)) for x, y in zip(a, b))


def test_shared_scan_over_npy_and_encoded_sources_bitwise_resident(tmp_path):
    p = _packed()
    npy = TD.NpyMmapSource(RD.NpyMmapSource.save(p, tmp_path / "npy"))
    enc = TD.EncodedSource(RD.EncodedSource.save(p, tmp_path / "enc", _encodings()))
    assert enc.encodings
    want = _serve_schedule(SV.SharedScan(_family(), _shards(), rounds=ROUNDS, device="cpu"))
    for src in (npy, enc):
        scan = SV.SharedScan(_family(), src, rounds=ROUNDS, device="cpu")
        try:
            got = _serve_schedule(scan)
            assert scan.io_stats["slices"] == ROUNDS
        finally:
            scan.close()
        assert _same_run(got, want)
    # the witnessed view of an encoded source is its logical columns
    view = SV.witnessed_view(enc, [(2, 4), (0, 2)])
    for k, v in view.items():
        assert torch.equal(v, torch.tensor(np.concatenate([p[k][:, 2:4], p[k][:, 0:2]],
                                                          axis=1))), k
    # the reference hands the encoded words to the closures undecoded
    ref = RSV.SharedScan(_ref_family(), RD.EncodedSource(tmp_path / "enc"), rounds=ROUNDS)
    ref.attach(_ref_query(Q_SCALAR))
    with pytest.raises(TypeError, match="broadcast"):
        ref.step()


# ---------------------------------------------------------------------------
# the asyncio service
# ---------------------------------------------------------------------------

def test_service_converge_park_unpark_and_cancel():
    fam, shards = _family(), _shards()

    async def main():
        async with SV.OLAService(fam, rounds=ROUNDS, grace_s=0.1, device="cpu") as svc:
            h1 = await svc.submit(T.QuerySpec(Q_SCALAR, stop=T.rel_width(0.9)), shards)
            h2 = await svc.submit(Q_LATE, shards)
            o1 = await h1.result()
            o2 = await h2.result()
            # a generous rule converges q1 early; q2 rides the scan a full pass
            assert o1.converged and o1.rounds_witnessed < o2.rounds_witnessed
            assert not o2.converged and o2.rounds_witnessed == ROUNDS
            assert o2.scanned == o2.d_total == svc.scan_for(shards).d_total
            assert o2.estimate.estimate.device.type == "cpu"
            scan = svc.scan_for(shards)
            steps_before = scan.steps_done
            await asyncio.sleep(0.4)
            assert svc.is_parked(shards)  # grace elapsed: the drive task ended
            h3 = await svc.submit(Q_GROUP, shards)  # un-park
            h4 = await svc.submit(Q_LATE, shards)
            svc.cancel(h4)
            o3, o4 = await h3.result(), await h4.result()
            assert o3.rounds_witnessed == ROUNDS and o4.rounds_witnessed < ROUNDS
            assert svc.scan_for(shards) is scan  # the same scan kept its cursor
            assert scan.steps_done > steps_before

    asyncio.run(asyncio.wait_for(main(), 60))


def test_service_fingerprints_a_shards_dict_once(monkeypatch):
    """submit, scan_for and is_parked hash a shards dict's content once per
    dict object, not on every call; an equal dict finds the same scan."""
    hashed = []
    real = TD.content_fingerprint
    monkeypatch.setattr(TD, "content_fingerprint",
                        lambda *a: hashed.append(1) or real(*a))
    fam, shards = _family(), _shards()

    async def main():
        async with SV.OLAService(fam, rounds=ROUNDS, device="cpu") as svc:
            handles = [await svc.submit(q, shards) for q in (Q_SCALAR, Q_LATE, Q_GROUP)]
            scan = svc.scan_for(shards)
            svc.is_parked(shards)
            assert len(hashed) == 1
            assert svc.scan_for(dict(shards)) is scan and len(hashed) == 2
            for h in handles:
                await h.result()

    asyncio.run(asyncio.wait_for(main(), 60))


def test_service_rejects_bad_submissions():
    fam, shards = _family(), _shards()

    async def main():
        async with SV.OLAService(fam, rounds=ROUNDS, device="cpu") as svc:
            with pytest.raises(TypeError, match="SlotQuery or a QuerySpec"):
                await svc.submit(TT.q6_func, shards)
            with pytest.raises(TypeError, match="must be a SlotQuery here"):
                await svc.submit(T.QuerySpec(T.make_sum_gla(
                    TT.q6_func, TT.q6_cond(TT.Q6_LOW_WINDOW), d_total=float(ROWS))), shards)
            with pytest.raises(ValueError, match="compile-time static"):
                await svc.submit(T.QuerySpec(Q_SCALAR, confidence=0.5), shards)
        with pytest.raises(RuntimeError, match="closed"):
            await svc.submit(Q_SCALAR, shards)

    asyncio.run(asyncio.wait_for(main(), 60))
    # the reference rejects the same submissions with the same words
    async def ref():
        async with RSV.OLAService(_ref_family(), rounds=ROUNDS) as svc:
            with pytest.raises(ValueError) as e:
                await svc.submit(RQuerySpec(_ref_query(Q_SCALAR), confidence=0.5),
                                 {k: jnp.asarray(v) for k, v in _packed().items()})
            return str(e.value)

    msg = asyncio.run(ref())
    assert msg.replace("0.5", "X") == (
        "per-query confidence X != service confidence 0.95: confidence is a "
        "compile-time static of the shared step — set it on OLAService(...)")


def test_a_failed_step_fails_its_queries_instead_of_hanging():
    fam = T.SlotFamily(exprs={"bad": lambda c: c["no such column"]},
                       pred_cols=("shipdate",))

    async def main():
        async with SV.OLAService(fam, rounds=ROUNDS, device="cpu") as svc:
            h = await svc.submit(T.SlotQuery("bad"), _shards())
            with pytest.raises(KeyError, match="no such column"):
                await h.result()

    asyncio.run(asyncio.wait_for(main(), 60))


def test_service_binds_its_worker_to_an_indexed_card(monkeypatch):
    """"cuda" resolves to the current card's index, which the worker
    thread's initializer hands to ``torch.cuda.set_device`` (a bare "cuda"
    device has no index there)."""
    bound = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    dev = SV._service_device(None)
    assert dev == torch.device("cuda", 3)
    SV._use_device(dev)
    assert bound == [dev] and SV._service_device("cuda:1").index == 1
    SV._use_device(SV._service_device("cpu"))
    assert bound == [dev]


def test_follow_runs_only_on_a_follower_rank():
    """``OLAService(mesh=)`` serves across processes
    (``test_torch_service_dist.py``); ``follow`` is its ranks' side, and a
    service without a mesh, or rank 0, has none."""
    with pytest.raises(RuntimeError, match="ranks other than 0"):
        SV.OLAService(_family(), rounds=ROUNDS, device="cpu").follow(_shards())


def test_a_mesh_without_its_store_is_refused():
    class Group:  # a PartitionGroup built around a group whose store is unknown
        store, rank, device = None, 0, torch.device("cpu")

    with pytest.raises(ValueError, match="init_partition_group"):
        SV.OLAService(_family(), rounds=ROUNDS, mesh=Group())


def test_a_bad_query_raises_at_submit_and_the_service_serves_on():
    async def main():
        async with SV.OLAService(_family(), rounds=ROUNDS, device="cpu") as svc:
            for q, words in ((T.SlotQuery("nope"), "unknown expression"),
                             (T.SlotQuery("q6", group="nope"), "unknown group key"),
                             (T.SlotQuery("q6", {"nope": (0.0, 1.0)}), "pred_cols")):
                with pytest.raises(KeyError, match=words):
                    await svc.submit(q, _shards())
            assert not svc._runners  # nothing reached a scan
            out = await (await svc.submit(Q_SCALAR, _shards())).result()
            assert out.rounds_witnessed == ROUNDS

    asyncio.run(asyncio.wait_for(main(), 60))


class _StoreMesh:
    """The part of a ``PartitionGroup`` that a service over a mesh uses
    while no scan is open — a store, a rank, the group's timeout — over one
    in-process store shared by two "ranks" in threads."""

    post, fetch, reset_stats = (SH.PartitionGroup.post, SH.PartitionGroup.fetch,
                                SH.PartitionGroup.reset_stats)

    def __init__(self, store, rank, timeout):
        self.store, self.rank, self.timeout = store, rank, timeout
        self.device = torch.device("cpu")
        self.reset_stats()


def _follow_in_thread(svc):
    """``svc.follow`` in a thread: its seconds and how it ended."""
    import threading

    out = {}

    def run():
        t0 = time.monotonic()
        try:
            svc.follow({})
            out["end"] = "returned"
        except Exception as e:
            out["end"] = f"{type(e).__name__}: {e}"
        out["s"] = time.monotonic() - t0

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def test_a_follower_waits_on_rank_0s_heartbeat_past_the_timeout_then_closes():
    """No record comes for three group timeouts while rank 0's service is
    open: its heartbeat keeps the follower waiting, and the close record
    ends ``follow``."""
    timeout, store = 0.8, torch.distributed.HashStore()
    rank0 = SV.OLAService(_family(), rounds=ROUNDS, mesh=_StoreMesh(store, 0, timeout))
    follower = SV.OLAService(_family(), rounds=ROUNDS, mesh=_StoreMesh(store, 1, timeout))
    t, out = _follow_in_thread(follower)
    time.sleep(3 * timeout)
    assert t.is_alive()
    asyncio.run(rank0.close())
    t.join(5.0)
    assert out["end"] == "returned" and out["s"] > 3 * timeout


def test_a_follower_gives_up_when_rank_0_is_gone():
    """Rank 0 built its service and went quiet (its heartbeat stopped, as
    when its process dies): the follower raises after the group's timeout,
    instead of waiting for ever."""
    timeout, store = 0.8, torch.distributed.HashStore()
    rank0 = SV.OLAService(_family(), rounds=ROUNDS, mesh=_StoreMesh(store, 0, timeout))
    rank0._quiet.set()
    follower = SV.OLAService(_family(), rounds=ROUNDS, mesh=_StoreMesh(store, 1, timeout))
    t, out = _follow_in_thread(follower)
    t.join(10 * timeout)
    assert out["end"] == ("TimeoutError: rank 0 of the service sent no record and "
                          "no heartbeat for 0.8 s")
    assert timeout < out["s"] < 10 * timeout
    asyncio.run(rank0.close())


def test_serving_cli_on_the_cpu(capsys):
    TCLI.main(["--rows", "20000", "--parts", "4", "--chunk", "256", "--queries", "4",
               "--qps", "200", "--eps", "0.2", "--grace", "0.05", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("  q0") == 4
    assert "served 4 queries" in out and "step plan" in out


# ---------------------------------------------------------------------------
# two gloo ranks on the CPU, bitwise one process
# ---------------------------------------------------------------------------

def _rank_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    out = Path(out_dir) / f"{rank}.pkl"
    try:
        mesh = SH.init_partition_group("gloo", f"file://{store}", rank, world, "cpu",
                                       timeout=TIMEOUT)
        try:
            lo, hi = mesh.bounds(PARTS)
            block = {k: v[lo:hi] for k, v in _shards().items()}
            scan = SV.SharedScan(_family(), block, rounds=ROUNDS, mesh=mesh)
            run = _serve_schedule(scan)
            stopped = scan.attach(Q_LATE, stop=lambda prog: prog.round >= 1 + rank)
            scan.step()
            res = {"run": run, "stopped": stopped.converged,
                   "plans": sorted((b.name, sorted(b.plans)) for b in scan.banks.values())}
        finally:
            mesh.close()
        out.write_bytes(pickle.dumps(("ok", res)))
    except BaseException:
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise


def test_two_gloo_ranks_bitwise_one_process(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, 2, str(tmp_path / "store"),
                                                  str(tmp_path)), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    want = _serve_schedule(SV.SharedScan(_family(), _shards(), rounds=ROUNDS, device="cpu"))
    for r in range(2):
        status, res = pickle.loads((tmp_path / f"{r}.pkl").read_bytes())
        assert status == "ok", res
        assert _same_run(res["run"], want), f"rank {r}"
        assert res["stopped"]  # rank 0's rule (stop after round 1) decides for both
