"""The plan auditor (``repro_torch.audit``) on the CPU, against the
reference's (``repro/analysis/audit.py``).

Both audit the same plans over the same rows: the reference's
``_smoke_data(8_000, 2, 128, 4)`` shards (P=2, C=32, L=128: 8 chunks a
round-slice), handed to the port through ``convert.shards_from_reference``.
Held here:

- parity, plan by plan (the four smoke plans, the CLI's encoded bundle and
  a ``kernel_cols``-only Q1 on the legacy K3 path): the same plan fields
  but ``backend``, the same status for every check of ``ALL_CHECKS`` but
  the stated differences (:data:`DIFFERENCES`), equal ``bytes_moved``
  bytes and ratio, equal ``probe_bytes``;
- that every check passing on a plan fails on a doctored copy (a chunk
  folded twice, a wrapper dispatching twice, a step handed every chunk, a
  bfloat16 carry, an encoding that does not shrink the stream, a bank
  building a plan at every arrival, a merge gathering twice);
- the pure checks and the report mechanics (as ``tests/test_audit.py``);
- ``Session(audit=)``: the report, the check subset, none; an
  ``AuditError`` before the session reads a slice; the run bitwise the
  unaudited one, the counters untouched, a ``FailingSource`` left as it was;
- ``audit_service`` and the repaired ``SharedScan.compile_budget`` against
  the reference's;
- a gloo group of W=2 (spawned as ``test_torch_sharded.py`` spawns its)
  passing ``one_collective_per_round`` with equal calls at two slice widths;
- the CLI on the CPU.
"""
import multiprocessing
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch as T
from repro.analysis import audit as RA
from repro.core import engine as RE
from repro.core.gla import SlotFamily as RSlotFamily
from repro.data import encodings as RENC
from repro.data import tpch as RTP
from repro.data.source import EncodedSource as REncodedSource
from repro.serving import service as RSV
from repro_torch import audit as TA
from repro_torch import convert
from repro_torch import engine as TE
from repro_torch import fault as TF
from repro_torch import scan as TSC
from repro_torch import service as TSV
from repro_torch import sharded as SH
from repro_torch.data import source as TD
from repro_torch.kernels import _runtime as RT
from repro_torch.kernels import fused_agg as TFA
from repro_torch.kernels import ops as TOPS
from repro_torch.uda import tree_map

ROWS, PARTS, CHUNK, ROUNDS = 8_000, 2, 128, 4
TIMEOUT = 60.0  # seconds a rank waits in a collective before it gives up
JOIN_S = 240.0  # seconds a spawned group may take in all

#: (check, the reference's status) -> (the port's status, why): the only
#: statuses in which the port may differ from the reference on these plans
DIFFERENCES = {
    ("no_recompile_across_rounds", "pass"): (
        "skip", "the port compiles no step program: there is no cache to watch"),
}

PLANS = ("q6", "q1", "bundle", "q3-join", "encoded-bundle", "q1-kernel-cols")


# ---------------------------------------------------------------------------
# fixtures: the reference's shards and plans, the port's, and both audits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def np_shards():
    return {k: np.asarray(v) for k, v in RA._smoke_data(ROWS, PARTS, CHUNK, ROUNDS).items()}


@pytest.fixture(scope="module")
def shards(np_shards):
    return convert.shards_from_reference(np_shards, "cpu")


def _ref_plans(np_shards):
    plans = {n: (q, emit, None) for n, q, emit in RA._smoke_plans(ROWS)}
    esrc = REncodedSource.from_shards(np_shards, {
        "discount": RENC.dict_encoding_for(np_shards["discount"]),
        "shipdate": RENC.BitPackedEncoding(bits=16),
        "rfls": RENC.BitPackedEncoding(bits=2)})
    plans["encoded-bundle"] = (plans["bundle"][0], "kernel", esrc)
    plans["q1-kernel-cols"] = (plans["q1"][0].with_(fused=None), "kernel", None)
    return plans


def _port_plans(np_shards):
    plans = {n: (q, emit, None) for n, q, emit in TA._smoke_plans(ROWS, device="cpu")}
    esrc = TD.EncodedSource.from_shards(np_shards, TA.smoke_encodings(np_shards))
    plans["encoded-bundle"] = (plans["bundle"][0], "kernel", esrc)
    plans["q1-kernel-cols"] = (plans["q1"][0].with_(fused=None), "kernel", None)
    return plans


@pytest.fixture(scope="module")
def port_plans(np_shards):
    return _port_plans(np_shards)


@pytest.fixture(scope="module")
def ref_reports(np_shards):
    return {name: RE.audit_plan(q, np_shards if src is None else src, rounds=ROUNDS,
                                emit=emit, checks=RA.ALL_CHECKS)
            for name, (q, emit, src) in _ref_plans(np_shards).items()}


def _audit(port_plans, shards, name, checks=TA.ALL_CHECKS):
    q, emit, src = port_plans[name]
    return TE.audit_plan(q, shards if src is None else src, rounds=ROUNDS, emit=emit,
                         device="cpu", checks=checks)


@pytest.fixture(scope="module")
def port_reports(port_plans, shards):
    return {name: _audit(port_plans, shards, name) for name in PLANS}


# ---------------------------------------------------------------------------
# parity with the reference, plan by plan
# ---------------------------------------------------------------------------

def test_the_table_of_differences_is_one_entry():
    assert len(DIFFERENCES) == 1


@pytest.mark.parametrize("name", PLANS)
def test_audit_plan_matches_the_reference(name, ref_reports, port_reports):
    ref, got = ref_reports[name], port_reports[name]
    strip = lambda plan: {k: v for k, v in plan.items() if k != "backend"}  # noqa: E731
    assert strip(got.plan) == strip(ref.plan)
    assert got.plan["backend"] == "cpu"
    assert [r.name for r in got.results] == list(RA.ALL_CHECKS)
    for r_ref, r in zip(ref.results, got.results):
        want, why = DIFFERENCES.get((r.name, r_ref.status), (r_ref.status, None))
        assert r.status == want, (name, r.name, r_ref, r, why)
    assert got.ok, got.summary()
    bm_ref, bm = ref.result("bytes_moved"), got.result("bytes_moved")
    assert bm.status == bm_ref.status
    if bm.passed:
        for k in ("physical_bytes", "logical_bytes", "ratio"):
            assert bm.data[k] == bm_ref.data[k], k
    fd_ref, fd = ref.result("fused_single_dispatch"), got.result("fused_single_dispatch")
    if fd.passed:
        assert fd.data["probe_bytes"] == fd_ref.data["probe_bytes"]
        assert fd.data["probe_budget_bytes"] == fd_ref.data["probe_budget_bytes"]


def test_audit_reads_the_counts_it_claims(port_reports, port_plans):
    """The dry step's exact counts: 8 chunk steps of an 8-chunk slice, one
    K1 (or K3) dispatch for both partitions, the decode's own launch, and
    handed bytes of one logical slice plus the carry."""
    rep = port_reports["q6"]
    assert rep.result("one_chunk_pass").data == {"chunk_steps": 8, "width": 8, "expected": 8}
    fp = rep.result("o_slice_footprint").data
    assert fp["handed_bytes"] == fp["ceiling_bytes"] == fp["slice_bytes"] + fp["carry_bytes"]
    assert fp["slice_bytes"] == 9 * PARTS * 8 * CHUNK * 4 and fp["peak_bytes"] is None
    assert port_reports["q1"].result("fused_single_dispatch").data["dispatches"] == {
        "fused_round_step/group": 1}
    enc = port_reports["encoded-bundle"].result("fused_single_dispatch").data
    assert enc["dispatches"] == {"fused_round_step/bundle": 1, "decode": 1}
    assert enc["decode_launches"] == 1 and enc["decode_in_kernel"] is False
    assert port_reports["q1-kernel-cols"].result("single_kernel_dispatch").data[
        "dispatches"] == {"group_agg": 1}
    assert port_reports["q1-kernel-cols"].plan["path"] == "kernel_group"
    assert "port compiles no step program" in rep.result("no_recompile_across_rounds").detail


# ---------------------------------------------------------------------------
# every passing check fails on a doctored plan
# ---------------------------------------------------------------------------

def _twice(fn):
    def wrapper(*a, **kw):
        fn(*a, **kw)
        return fn(*a, **kw)
    return wrapper


def _fold_twice(mp):
    mp.setattr(TSC, "accumulate_chunk", _twice(TSC.accumulate_chunk))


def _dispatch_twice(mp):
    for mod, fn in ((TFA, "scalar_round_step"), (TFA, "group_round_step"),
                    (TFA, "bundle_round_step"), (TOPS, "group_agg"),
                    (TOPS, "shard_chunk_partials")):
        mp.setattr(mod, fn, _twice(getattr(mod, fn)))


def _hand_every_chunk(mp):
    read = TA._read_slice
    mp.setattr(TA, "_read_slice", lambda p, lo, hi: read(p, 0, p.C))


def _bf16_carry(mp):
    step = TSC.round_step

    def doctored(*a, **kw):
        states, views = step(*a, **kw)
        return tree_map(lambda x: x.to(torch.bfloat16), states), views
    mp.setattr(TSC, "round_step", doctored)


def _no_shrink(mp):
    mp.setattr(TD.ChunkSource, "physical_columns", lambda self: self.spec.columns)


DOCTORS = {
    "one_chunk_pass": _fold_twice,
    "o_slice_footprint": _hand_every_chunk,
    "single_kernel_dispatch": _dispatch_twice,
    "fused_single_dispatch": _dispatch_twice,
    "bytes_moved": _no_shrink,
    "dtype_discipline": _bf16_carry,
}


def _passing(name):
    """The checks the port passes on plan ``name`` (from the reference's
    smoke statuses, which the parity test holds the port to)."""
    base = {"o_slice_footprint", "dtype_discipline"}
    return sorted(base | {
        "q6": {"one_chunk_pass"}, "q1": {"fused_single_dispatch"},
        "bundle": {"fused_single_dispatch"}, "q3-join": {"fused_single_dispatch"},
        "encoded-bundle": {"fused_single_dispatch", "bytes_moved"},
        "q1-kernel-cols": {"single_kernel_dispatch"}}[name])


@pytest.mark.parametrize("name,check", [(n, c) for n in PLANS for c in _passing(n)])
def test_every_passing_check_fails_on_a_doctored_plan(name, check, port_plans, shards,
                                                      port_reports, monkeypatch):
    assert port_reports[name].result(check).passed
    DOCTORS[check](monkeypatch)
    rep = _audit(port_plans, shards, name, checks=(check,))
    assert rep.result(check).failed, rep.summary()
    assert not rep.ok


def test_the_doctored_checks_cover_every_passing_check(port_reports):
    passing = {r.name for rep in port_reports.values() for r in rep.results if r.passed}
    assert passing == set(DOCTORS)
    for name in PLANS:
        assert {r.name for r in port_reports[name].results if r.passed} == set(_passing(name))


# ---------------------------------------------------------------------------
# the pure checks and the report mechanics
# ---------------------------------------------------------------------------

def test_check_one_chunk_pass_pass_and_fail():
    ok = TA.check_one_chunk_pass(12, width=12)
    assert ok.passed and ok.data["chunk_steps"] == 12
    assert TA.check_one_chunk_pass(24, width=12).failed  # a chunk folded twice
    assert TA.check_one_chunk_pass(0, width=12).failed  # never scanned
    assert TA.check_one_chunk_pass(24, width=12, expected=2).passed


def test_check_slice_footprint_bounds():
    kw = dict(slice_bytes=1000, carry_bytes=24, floor_bytes=100)
    ok = TA.check_slice_footprint(1024, **kw)
    assert ok.passed and ok.data["ceiling_bytes"] == 1024
    # below one live column: the count no longer reads the inputs
    assert TA.check_slice_footprint(50, **kw).failed
    # past one slice plus the carry
    assert TA.check_slice_footprint(1025, **kw).failed
    # below the dataset, when it is larger than one slice
    assert TA.check_slice_footprint(1000, **kw, dataset_bytes=8000).passed
    assert TA.check_slice_footprint(1010, slice_bytes=1000, carry_bytes=24,
                                    floor_bytes=100, dataset_bytes=1010).failed
    assert TA.check_slice_footprint(1000, slice_bytes=1000, carry_bytes=24,
                                    floor_bytes=100, dataset_bytes=1000).passed
    # the card's peak: at most PEAK_SLICES slices
    assert TA.check_slice_footprint(1000, **kw, peak_bytes=4000).passed
    bad = TA.check_slice_footprint(1000, **kw, peak_bytes=4001)
    assert bad.failed and "peak" in bad.detail


def test_check_dispatches_counts():
    ok = TA.check_dispatches("single_kernel_dispatch", {"group_agg": 1, "decode": 0},
                             expected={"group_agg": 1, "decode": 0})
    assert ok.passed and ok.data["dispatches"] == {"group_agg": 1}
    assert TA.check_dispatches("x", {"group_agg": 2}, expected={"group_agg": 1}).failed
    assert TA.check_dispatches("x", {"group_agg": 1, "decode": 1},
                               expected={"group_agg": 1}).failed
    assert TA.check_dispatches("x", {}, expected={"group_agg": 1}).failed


def test_check_collectives():
    ok = TA.check_collectives(2, width=8)
    assert ok.passed and ok.data == {"calls": 2, "expected": 2, "width": 8}
    lost = TA.check_collectives(0, width=8)
    assert lost.failed and "lost" in lost.detail
    per_chunk = TA.check_collectives(2 + 8, width=8)
    assert per_chunk.failed and "per chunk" in per_chunk.detail


def test_check_dtype_discipline():
    assert TA.check_dtype_discipline({"states": {"s": torch.zeros(4)}}).passed
    bad = TA.check_dtype_discipline({"states": (torch.zeros(4, dtype=torch.float16),)})
    assert bad.failed and "states" in bad.detail
    assert TA.check_dtype_discipline({"states": torch.zeros(2, dtype=torch.bfloat16)}).failed
    # integer leaves (group ids, counts) are not a downcast
    assert TA.check_dtype_discipline({"views": torch.zeros(4, dtype=torch.int8)}).passed
    assert TA.check_dtype_discipline({"estimate": None}).passed


def test_report_mechanics():
    good = TA.CheckResult("a", "pass", "fine")
    bad = TA.CheckResult("b", "fail", "broken")
    skip = TA.CheckResult("c", "skip", "n/a")
    rep = TA.AuditReport(plan={"gla": "g"}, results=(good, skip))
    assert rep.ok and rep.failures == ()
    rep.raise_for_failures()  # no failures: no raise
    assert rep.result("a").passed and rep.result("c").skipped
    with pytest.raises(KeyError):
        rep.result("zzz")
    rep2 = TA.AuditReport(plan={"gla": "g"}, results=(good, bad))
    assert not rep2.ok and rep2.failures == (bad,)
    with pytest.raises(TA.AuditError, match="broken"):
        rep2.raise_for_failures()
    assert "FAIL" in rep2.summary() and "broken" in rep2.summary()
    assert str(skip) == "[skip] c: n/a"


def test_audit_plan_unknown_check_raises(port_plans, shards):
    with pytest.raises(ValueError, match="unknown audit check"):
        _audit(port_plans, shards, "q6", checks=("one_chunk_pass", "nope"))


def test_static_and_all_checks_are_the_references():
    assert TA.STATIC_CHECKS == RA.STATIC_CHECKS and TA.ALL_CHECKS == RA.ALL_CHECKS


def test_a_plan_that_cannot_step_skips_the_dry_step_checks(port_plans, shards):
    q, _, _ = port_plans["q6"]
    rep = TE.audit_plan(q, shards, rounds=ROUNDS, emit="chunk", mode="sync",
                        device="cpu", checks=TA.ALL_CHECKS)
    assert rep.ok
    for name in ("one_chunk_pass", "o_slice_footprint"):
        assert rep.result(name).skipped and "cannot step" in rep.result(name).detail
    assert rep.result("dtype_discipline").passed  # the carry alone


# ---------------------------------------------------------------------------
# Session(audit=)
# ---------------------------------------------------------------------------

def _counters():
    return dict(RT.LAUNCHES), dict(RT.DISPATCHES), TSC.CHUNK_STEPS


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _run(sess):
    while not sess.done:
        sess.step()
    r = sess.result()
    return r.final, r.snapshots, r.estimates


@pytest.mark.parametrize("name", ["q6", "q1", "q1-kernel-cols"])
def test_session_audit_kwarg(name, port_plans, shards):
    q, emit, _ = port_plans[name]
    spec = T.QuerySpec(q, rounds=ROUNDS, emit=emit)
    before = _counters()
    sess = T.Session(spec, shards, device="cpu", audit=True)
    assert _counters() == before  # the audit put every counter back
    assert sess.audit_report is not None and sess.audit_report.ok
    assert [r.name for r in sess.audit_report.results] == list(TA.STATIC_CHECKS)
    RT.reset_launch_counts()
    got = _run(sess)
    audited = RT.dispatch_counts()
    RT.reset_launch_counts()
    want = _run(T.Session(spec, shards, device="cpu"))
    assert _bitwise(got, want)
    assert audited == RT.dispatch_counts()
    sub = T.Session(spec, shards, device="cpu", audit=("one_chunk_pass", "dtype_discipline"))
    assert [r.name for r in sub.audit_report.results] == ["one_chunk_pass",
                                                         "dtype_discipline"]
    assert T.Session(spec, shards, device="cpu").audit_report is None


class _CountingSource(TD.ChunkSource):
    """A streaming view of in-memory shards that counts its reads."""

    def __init__(self, shards):
        self.inner = TD.InMemorySource(shards)
        self.spec = self.inner.spec
        self.reads = []

    def slice_cols(self, lo, hi):
        self.reads.append((lo, hi))
        return {k: v.numpy() for k, v in self.inner.slice_cols(lo, hi).items()}

    def mask_chunk_sums(self):
        return self.inner.mask_chunk_sums()


def test_session_audit_error_is_raised_before_the_session_reads_a_slice(
        port_plans, shards, monkeypatch):
    q, emit, _ = port_plans["q6"]
    src = _CountingSource(shards)
    _fold_twice(monkeypatch)
    with pytest.raises(TA.AuditError, match="one_chunk_pass"):
        T.Session(T.QuerySpec(q, rounds=ROUNDS, emit=emit), src, device="cpu", audit=True)
    assert src.reads == [(0, 8)]  # the audit's dry read alone


def test_session_audit_leaves_a_failing_source_as_it_was(port_plans, shards):
    """A FailingSource whose partition 1 dies inside round 0: the audit's
    dry read goes through its inner source, so the audited session records
    the loss where the unaudited one does, bitwise."""
    q, _, _ = port_plans["q6"]
    spec = T.QuerySpec(q, rounds=ROUNDS, emit="kernel", fault=T.FaultPolicy("single"))
    runs = []
    for audit in (True, None):
        src = TF.FailingSource(shards, {1: 3})
        sess = T.Session(spec, src, device="cpu", audit=audit)
        assert src._dead == set()
        runs.append((_run(sess), dict(sess._fail_at)))
    assert runs[0][1] == runs[1][1] == {1: 0}
    assert _bitwise(runs[0][0], runs[1][0])


# ---------------------------------------------------------------------------
# serving: audit_service and the repaired compile budget
# ---------------------------------------------------------------------------

def _ref_family():
    return RSlotFamily(exprs={"q6": RTP.q6_func, "qty": lambda c: c["quantity"]},
                       pred_cols=("shipdate", "discount"),
                       groups={"rfls": (RTP.q1_group_small, 4)})


def test_audit_service_matches_the_reference(np_shards, shards):
    ref = RA.audit_service(_ref_family(), np_shards, rounds=ROUNDS)
    before = _counters()
    got = TA.audit_service(TA.smoke_family(), shards, rounds=ROUNDS, device="cpu")
    assert _counters() == before
    r_ref, r = ref.results[0], got.results[0]
    assert r.name == r_ref.name == "bounded_compiles_under_churn"
    assert r.status == r_ref.status == "pass"
    for k in ("arrivals", "doublings", "banks", "stepped_capacities", "reused_slot",
              "cache_miss_delta", "budget"):
        assert r.data[k] == r_ref.data[k], k
    strip = lambda plan: {k: v for k, v in plan.items() if k != "backend"}  # noqa: E731
    assert strip(got.plan) == strip(ref.plan)


def test_audit_service_fails_when_a_bank_builds_a_plan_at_every_arrival(shards, monkeypatch):
    attach = TSV._Bank.attach

    def rebuild(self, q, stop):
        self.plans.clear()
        return attach(self, q, stop)
    monkeypatch.setattr(TSV._Bank, "attach", rebuild)
    r = TA.audit_service(TA.smoke_family(), shards, rounds=ROUNDS, device="cpu").results[0]
    assert r.failed and r.data["cache_miss_delta"] > r.data["budget"], r


def _churn(scan, SlotQuery):
    """The same arrivals, departures and steps on either package's scan."""
    rng = np.random.default_rng(5)
    live, arrivals = [], 0
    for _ in range(6):
        for _ in range(int(rng.integers(1, 5))):
            lo = float(rng.integers(0, 2000))
            live.append(scan.attach(SlotQuery(
                ["q6", "qty"][arrivals % 2], {"shipdate": (lo, lo + 400.0)},
                group="rfls" if arrivals % 5 == 4 else None)))
            arrivals += 1
        for j in sorted(rng.choice(len(live), min(2, len(live)), replace=False),
                        reverse=True):
            scan.detach(live.pop(int(j)))
        for rec, _ in scan.step():
            if rec.done:
                scan.detach(rec)
                live.remove(rec)
    return arrivals


def test_compile_budget_counts_the_capacities_stepped_as_the_reference(
        np_shards, shards, monkeypatch):
    from repro.core.gla import SlotQuery as RQ

    ref = RSV.SharedScan(_ref_family(), np_shards, rounds=ROUNDS)
    _churn(ref, RQ)
    scan = TSV.SharedScan(TA.smoke_family(), shards, rounds=ROUNDS, device="cpu")
    before = TSV.serve_step_cache_sizes()
    arrivals = _churn(scan, T.SlotQuery)
    assert scan.compile_budget() == ref.compile_budget() < arrivals
    assert {n: sorted(b.stepped_ks) for n, b in scan.banks.items()} == {
        n: sorted(b.stepped_ks) for n, b in ref.banks.items()}
    assert TSV.serve_step_cache_sizes() - before == scan.compile_budget()
    # a bank that rebuilds its plan at every arrival now exceeds the budget
    attach = TSV._Bank.attach

    def rebuild(self, q, stop):
        self.plans.clear()
        return attach(self, q, stop)
    monkeypatch.setattr(TSV._Bank, "attach", rebuild)
    scan = TSV.SharedScan(TA.smoke_family(), shards, rounds=ROUNDS, device="cpu")
    before = TSV.serve_step_cache_sizes()
    _churn(scan, T.SlotQuery)
    assert TSV.serve_step_cache_sizes() - before > scan.compile_budget()


# ---------------------------------------------------------------------------
# a gloo group of W=2: one_collective_per_round
# ---------------------------------------------------------------------------

def _rank_main(rank, world, store, data, out_dir):
    torch.set_num_threads(1)
    out = Path(out_dir) / f"{rank}.pkl"
    try:
        mesh = SH.init_partition_group("gloo", f"file://{store}", rank, world, "cpu",
                                       timeout=TIMEOUT)
        try:
            arrays = np.load(data)
            lo, hi = mesh.bounds(PARTS)
            block = {k: torch.from_numpy(arrays[k][lo:hi].copy()) for k in arrays.files}
            q6 = TA._smoke_plans(ROWS, device="cpu")[0][1]
            res = {}
            for rounds in (ROUNDS, 2 * ROUNDS):  # slice widths 8 and 4
                mesh.reset_stats()
                rep = TE.audit_plan(q6, block, rounds=rounds, emit="kernel", mesh=mesh,
                                    checks=TA.ALL_CHECKS)
                r = rep.result("one_collective_per_round")
                res[rounds] = (rep.ok, r.status, r.data, mesh.stats()["calls"])
            spec = T.QuerySpec(q6, rounds=ROUNDS, emit="kernel")
            sess = T.Session(spec, block, mesh=mesh, audit=True)
            res["session"] = (sess.audit_report.ok, _run(sess),
                              _run(T.Session(spec, block, mesh=mesh)))
            gather = SH.PartitionGroup.gather

            def gather_twice(self, tree):  # a merge that gathers twice
                gather(self, tree)
                return gather(self, tree)
            SH.PartitionGroup.gather = gather_twice
            try:
                rep = TE.audit_plan(q6, block, rounds=ROUNDS, emit="kernel", mesh=mesh,
                                    checks=("one_collective_per_round",))
            finally:
                SH.PartitionGroup.gather = gather
            res["doctored"] = rep.results[0]
        finally:
            mesh.close()
        out.write_bytes(pickle.dumps(("ok", res)))
    except BaseException:
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise


def test_gloo_ranks_pass_one_collective_per_round(np_shards, tmp_path):
    data = tmp_path / "shards.npz"
    np.savez(data, **np_shards)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, PARTS, str(tmp_path / "store"),
                                                  str(data), str(tmp_path)), daemon=True)
             for r in range(PARTS)]
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
    res = []
    for r in range(PARTS):
        f = tmp_path / f"{r}.pkl"
        assert f.exists(), f"rank {r} wrote nothing (exit code {procs[r].exitcode})"
        status, out = pickle.loads(f.read_bytes())
        assert status == "ok", f"rank {r} failed:\n{out}"
        res.append(out)
    for out in res:
        calls = []
        for rounds, width in ((ROUNDS, 8), (2 * ROUNDS, 4)):
            ok, status, data, after = out[rounds]
            assert ok and status == "pass", out[rounds]
            assert data["width"] == width and data["calls"] == TA.ROUND_COLLECTIVES
            assert after == 0  # the group's stats put back
            calls.append(data["calls"])
        assert calls[0] == calls[1]
        audited_ok, got, want = out["session"]
        assert audited_ok and _bitwise(got, want)
        assert out["doctored"].failed and out["doctored"].data["calls"] == 3
    assert res[0][ROUNDS][2] == res[1][ROUNDS][2]  # the same calls on every rank


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_on_the_cpu(capsys):
    assert TA.main(["--device", "cpu", "--rows", "8000", "--rounds", "4"]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "audit-smoke: OK"
    assert sum(line.startswith("audit ") for line in out.splitlines()) == 6
