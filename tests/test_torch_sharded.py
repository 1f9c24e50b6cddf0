"""Partitions across processes (``repro_torch.sharded``) on the CPU.

gloo process groups of W=4 and W=2 ranks, spawned once per group under a
file store in ``tmp_path`` with a 60-second collective timeout, at the
reference's sizes (``tests/test_sharding.py``: P=8, chunk_len 256, 8 rounds;
32,768 rows, so C=16).  Each rank runs every case of :data:`CASES` through
the port's entry points with ``mesh=``, its data as its own resident block
``[P/W, C, L]`` or as a source over the whole layout, and writes what it got;
this process runs the same cases without a mesh and holds every rank's
results to them bit for bit: finals, every merged round state, every
estimate, the failure record and the stopping round — a one-node plan tree
and a Quantile sketch tree among the cases, the tree also bitwise its flat
GLA's run on every rank.  Also: the reference's refusals with its messages
(the max-monoid CountDistinct sketch among them), pause on W=4 resumed on W=2 (at P=8 and at
``partitions=4``) and in this process, a rank that raises failing the others
at once, the port's W=4 Q6 estimates within the reference's ``rtol=2e-5`` of
the reference's vmapped ``run_query``, and the three live-row sums that no
longer widen the whole mask to float64.
"""
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

import repro_torch as T
from repro.core import engine as RE
from repro.core import gla as RG
from repro.core import randomize as RR
from repro.data import tpch as RT
from repro_torch import ckpt
from repro_torch import fault as TF
from repro_torch import scan as TSC
from repro_torch import sharded as SH
from repro_torch.data import source as TD
from repro_torch.data import tpch as TT
from repro_torch.kernels import fused_agg as TFA
from repro_torch.uda import tree_map

ROWS, P, ROUNDS, L = 32768, 8, 8, 256  # C = 16: two chunks a round
TIMEOUT = 60.0  # seconds a rank waits in a collective before it gives up
JOIN_S = 240.0  # seconds a spawned group may take in all
PAUSE_AT = 3
FAIL = {2: 3}  # partition 2 lost at round 3


# ---------------------------------------------------------------------------
# the cases every rank runs, and this process without a mesh
# ---------------------------------------------------------------------------

def _q6(estimator="single"):
    return T.make_sum_gla(TT.q6_func, TT.q6_cond(TT.Q6_LOW_WINDOW),
                          d_total=float(ROWS), estimator=estimator)


def _q1(estimator="single"):
    return T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small,
                              num_groups=4, d_total=float(ROWS), num_aggs=4,
                              estimator=estimator)


def _glas():
    return {"q6": _q6(), "q1": _q1(), "bundle": T.GLABundle([_q6(), _q1()])}


def _drive(sess):
    while not sess.done:
        sess.step()
    return sess.result()


def _spec(gla, **kw):
    return T.QuerySpec(gla, rounds=ROUNDS, **kw)


def _C(data):
    return data["whole"].spec.C


def _straggler(data):
    return T.straggler_schedule(P, _C(data), 4, [1, 1, 1, 1, 2, 2, 3, 4], seed=3)


def _entry_cases():
    """run_query / run_queries / Session over scalar, group and bundle on
    every emit, the block form and the two whole-layout forms."""
    cases = {}
    for emit in ("chunk", "round", "kernel", "round_masked"):
        for name in ("q6", "q1"):
            cases[f"run_query {name} {emit}"] = (
                lambda d, kw, n=name, e=emit:
                T.run_query(_spec(_glas()[n], emit=e), d["block"], **kw))
            cases[f"session {name} {emit}"] = (
                lambda d, kw, n=name, e=emit:
                _drive(T.Session(_spec(_glas()[n], emit=e), d["block"], **kw)))
    for emit in ("round", "kernel"):
        cases[f"run_queries bundle {emit}"] = (
            lambda d, kw, e=emit:
            T.run_queries(_spec([_q6(), _q1()], emit=e), d["block"], **kw))
        cases[f"session bundle {emit}"] = (
            lambda d, kw, e=emit:
            _drive(T.Session(_spec(_glas()["bundle"], emit=e), d["block"], **kw)))
    cases["run_query q6 kernel, resident whole layout"] = (
        lambda d, kw: T.run_query(_spec(_q6(), emit="kernel"), d["resident"], **kw))
    for name in ("q6", "q1", "bundle"):
        cases[f"streamed session {name} kernel"] = (
            lambda d, kw, n=name:
            T.Session(_spec(_glas()[n], emit="kernel"), d["whole"], **kw).run())
    for cost in (True, False):
        cases[f"sync q6 chunk, sync_cost_model={cost}"] = (
            lambda d, kw, c=cost:
            T.run_query(T.QuerySpec(_q6(), schedule=_straggler(d), sync=True,
                                    emit="chunk", sync_cost_model=c),
                        d["block"], **kw))
    cases["sync q6 kernel (K2), sync_cost_model=False"] = (
        lambda d, kw: T.run_query(
            T.QuerySpec(_q6(), schedule=_straggler(d), sync=True, emit="kernel",
                        sync_cost_model=False), d["block"], **kw))
    cases["stop rule decided once"] = _stop_rule
    # plan trees: a one-node SumAgg tree (held to the flat Q6 run below) and
    # a Quantile sketch, an additive monoid
    cases["run_query q6 tree chunk"] = (
        lambda d, kw: T.run_query(_spec(_q6_tree(), emit="chunk"), d["block"], **kw))
    cases["run_query quantile tree chunk"] = (
        lambda d, kw: T.run_query(_spec(_quantile_tree(), emit="chunk"), d["block"], **kw))
    return cases


def _q6_tree():
    return T.SumAgg(T.Filter(T.Scan(float(ROWS)), TT.q6_cond(TT.Q6_LOW_WINDOW)),
                    TT.q6_func)


def _quantile_tree():
    return T.Quantile(T.Filter(T.Scan(float(ROWS)), TT.q1_cond),
                      lambda c: c["extendedprice"], lo=0.9, hi=105.0, bins=256, q=0.5)


def _stop_rule(d, kw):
    """A rule that would stop each rank at another round: rank 0's wins."""
    rank = kw["mesh"].rank if "mesh" in kw else 0
    sess = T.Session(_spec(_q6(), emit="kernel",
                           stop=lambda prog: prog.round >= 2 + 3 * rank),
                     d["block"], **kw)
    res = sess.run()
    return res, sess.steps_taken


def _fault_cases():
    cases = {}
    for est in ("single", "multiple", "synchronized"):
        cases[f"run_with_failures q6 {est}"] = (
            lambda d, kw, e=est: TF.run_with_failures(
                _q6(e), d["block"], estimator=e, rounds=ROUNDS, fail_at=FAIL, **kw))
    for name, est, emit in (("q1", "single", "kernel"), ("q1", "synchronized", "kernel"),
                            ("q6", "multiple", "round")):
        gla = _q1(est) if name == "q1" else _q6(est)
        cases[f"fault session {name} {est}"] = (
            lambda d, kw, g=gla, e=est, m=emit:
            _drive(T.Session(_spec(g, emit=m, fault=T.FaultPolicy(e, fail_at=FAIL)),
                             d["block"], **kw)))
    cases["source loss on one rank"] = _source_loss
    return cases


def _failing(d, kw):
    """The npy layout, failing under partition 2 inside round 3 — on the
    rank that owns partition 2 only (every source without a mesh)."""
    c_fail = FAIL[2] * (_C(d) // ROUNDS) + 1
    if "mesh" in kw and 2 not in range(*kw["mesh"].bounds(P)):
        return d["whole"]
    return TF.FailingSource(d["whole"], {2: c_fail})


def _source_loss(d, kw):
    sess = T.Session(_spec(_q6(), emit="kernel", fault=T.FaultPolicy("single")),
                     _failing(d, kw), **kw)
    res = _drive(sess)
    return res, dict(sess._fail_at)


CASES = {**_entry_cases(), **_fault_cases()}


def _no_policy_loss(d, kw):
    """Without a policy every rank raises the loss, at the same round."""
    sess = T.Session(_spec(_q6(), emit="kernel"), _failing(d, kw), **kw)
    try:
        _drive(sess)
    except TD.PartitionLostError as e:
        return type(e).__name__, list(e.partitions), sess.steps_taken
    return None


def _refusals(d, kw):
    """The sharded path's refusals, each raised on every rank alike."""
    out = {}
    for name, run in (
            ("non-additive", lambda: T.run_query(
                _spec(_q6().with_(merge_is_additive=False)), d["block"], **kw)),
            ("kernel sync cost", lambda: T.run_query(
                T.QuerySpec(_q6(), schedule=_straggler(d), sync=True, emit="kernel"),
                d["block"], **kw)),
            ("group kernel sync", lambda: T.run_query(
                T.QuerySpec(_q1(), sync=True, emit="kernel", sync_cost_model=False),
                d["block"], **kw)),
            ("round sync", lambda: T.run_query(
                T.QuerySpec(_q6(), sync=True, emit="round", sync_cost_model=False),
                d["block"], **kw)),
            ("count distinct", lambda: T.run_query(_spec(T.CountDistinct(
                T.Scan(float(ROWS)), lambda c: c["suppkey"])), d["block"], **kw)),
            ("P % W", lambda: T.Session(_spec(_q6()), TD.InMemorySource(
                {k: v[:6] for k, v in d["resident"].shards.items()}), **kw))):
        try:
            run()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _pause(d, kw, out_dir):
    """Q6 and Q1 on emit='kernel', and Q6 on the scan path, paused after
    PAUSE_AT rounds."""
    for name, gla, emit in (("q6", _q6(), "kernel"), ("q1", _q1(), "kernel"),
                            ("q6-scan", _q6(), "chunk")):
        sess = T.Session(_spec(gla, emit=emit), d["block"], **kw)
        for _ in range(PAUSE_AT):
            sess.step()
        sess.pause(Path(out_dir) / f"{name}.ckpt")


def _resume(d, kw, ckpt_dir):
    out = {}
    for name, gla in (("q6", _q6()), ("q1", _q1()), ("q6-scan", _q6())):
        for parts in (None, 4):
            sess = T.Session.resume(Path(ckpt_dir) / f"{name}.ckpt", gla, d["block"],
                                    partitions=parts, **kw)
            out[f"{name} partitions={parts}"] = _drive(sess)
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_data(data_dir, mesh):
    whole = TD.NpyMmapSource(data_dir)
    arrays = {k: np.load(Path(data_dir) / f"{k}.npy") for k in whole._host}
    lo, hi = mesh.bounds(P) if mesh is not None else (0, P)
    return {"whole": whole,
            "block": {k: torch.from_numpy(v[lo:hi].copy()) for k, v in arrays.items()},
            "resident": TD.InMemorySource({k: torch.from_numpy(v) for k, v in arrays.items()})}


def _job_main(d, kw, out_dir):
    res = {name: fn(d, kw) for name, fn in CASES.items()}
    res["no policy loss"] = _no_policy_loss(d, kw)
    res["refusals"] = _refusals(d, kw)
    _pause(d, kw, out_dir)
    res["collectives"] = kw["mesh"].stats()
    return res


def _job_resume(d, kw, out_dir):
    return _resume(d, kw, Path(out_dir).parent / "main")


class _RaisingSource(TD.ChunkSource):
    """A source whose read of round 2 raises on this rank."""

    def __init__(self, inner):
        self.inner, self.spec = inner, inner.spec

    def slice_cols(self, lo, hi):
        if lo >= 2 * (self.spec.C // ROUNDS):
            raise RuntimeError("disk gone under this rank")
        return self.inner.slice_cols(lo, hi)

    def mask_chunk_sums(self):
        return self.inner.mask_chunk_sums()


def _job_raise(d, kw, out_dir):
    """Rank 2 raises while reading round 2; every rank must stop with it."""
    src = _RaisingSource(d["whole"]) if kw["mesh"].rank == 2 else d["whole"]
    sess = T.Session(_spec(_q6(), emit="kernel"), src, **kw)
    t0 = time.perf_counter()
    try:
        _drive(sess)
    except RuntimeError as e:
        return {"error": str(e), "seconds": time.perf_counter() - t0,
                "steps": sess.steps_taken}
    return {"error": None}


JOBS = {"main": _job_main, "resume": _job_resume, "raise": _job_raise}


def _rank_main(job, rank, world, store, data_dir, out_dir):
    torch.set_num_threads(1)
    out = Path(out_dir) / f"{rank}.pkl"
    try:
        mesh = SH.init_partition_group("gloo", f"file://{store}", rank, world,
                                       "cpu", timeout=TIMEOUT)
        try:
            res = JOBS[job](_rank_data(data_dir, mesh), {"mesh": mesh}, out_dir)
        finally:
            mesh.close()
        out.write_bytes(pickle.dumps(("ok", res)))
    except BaseException:
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise


def _spawn(job, world, tmp: Path, data_dir):
    out_dir = tmp / job
    out_dir.mkdir()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(job, r, world, str(tmp / f"{job}.store"), str(data_dir),
                               str(out_dir)), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not hung, f"{job}: ranks {hung} still running after {JOIN_S} s"
    results = []
    for r in range(world):
        f = out_dir / f"{r}.pkl"
        assert f.exists(), f"{job}: rank {r} wrote nothing (exit code {procs[r].exitcode})"
        status, res = pickle.loads(f.read_bytes())
        assert status == "ok", f"{job}: rank {r} failed:\n{res}"
        results.append(res)
    return results


# ---------------------------------------------------------------------------
# fixtures: the data, the single-process twins, the spawned groups
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_shards():
    raw = RT.generate_lineitem(ROWS, seed=5)
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in raw.items()},
                                jax.random.key(7), P)
    return {k: np.asarray(v) for k, v in RR.pack_partitions(parts, chunk_len=L).items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory, ref_shards):
    tmp = tmp_path_factory.mktemp("sharded")
    data_dir = TD.NpyMmapSource.save(ref_shards, tmp / "npy")
    single = _rank_data(data_dir, None)
    kw = {"device": "cpu"}
    twins = {name: fn(single, kw) for name, fn in CASES.items()}
    twins["no policy loss"] = _no_policy_loss(single, kw)
    groups = {job: _spawn(job, w, tmp, data_dir)
              for job, w in (("main", 4), ("resume", 2), ("raise", 4))}
    return {"tmp": tmp, "single": single, "twins": twins, **groups}


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _result(x):
    """A case's result: a QueryResult, a list of them, or (result, what the
    case also reports)."""
    return x[0] if type(x) is tuple else x


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_bitwise_the_single_process_run(run, case):
    want = _result(run["twins"][case])
    assert _leaves(want), case
    for rank, res in enumerate(run["main"]):
        assert _bitwise(_result(res[case]), want), \
            f"{case}: rank {rank} differs from the one-process run"


def test_stop_rule_is_decided_by_rank_zero(run):
    assert [res["stop rule decided once"][1] for res in run["main"]] == [2, 2, 2, 2]


def test_source_loss_on_one_rank_is_recorded_on_all(run):
    want = run["twins"]["source loss on one rank"][1]
    assert want == FAIL
    assert [res["source loss on one rank"][1] for res in run["main"]] == [FAIL] * 4
    assert [res["no policy loss"] for res in run["main"]] == \
        [("PartitionLostError", [2], FAIL[2])] * 4 == [run["twins"]["no policy loss"]] * 4


def test_fault_families_keep_their_bounds_rules(run):
    fr = FAIL[2]
    res = run["main"][0]
    single = res["run_with_failures q6 single"].estimates
    assert torch.isfinite(single.lower).all() and torch.isfinite(single.upper).all()
    multiple = res["run_with_failures q6 multiple"].estimates
    assert torch.isneginf(multiple.lower[fr:]).all() and torch.isposinf(multiple.upper[fr:]).all()
    assert torch.isfinite(multiple.lower[:fr]).all()
    sync = res["fault session q1 synchronized"].estimates
    for x in (sync.estimate, sync.lower, sync.upper):
        assert torch.equal(x[fr:], x[fr - 1].expand_as(x[fr:]))


def test_refusals_with_the_reference_messages(run):
    for res in run["main"]:
        got = res["refusals"]
        assert got["non-additive"] == "sharded path requires additive merges"
        assert got["count distinct"] == "sharded path requires additive merges"
        assert got["kernel sync cost"].startswith(
            "emit='kernel' is incompatible with mode='sync' + sync_cost_model=True")
        assert got["group kernel sync"].startswith(
            "group-by/bundled emit='kernel' emits round states only")
        assert got["round sync"].startswith(
            "emit='round' emits round states only; mode='sync' needs prefix states")
        assert "do not split evenly over 4 ranks" in got["P % W"]


def test_flat_vs_tree_bitwise_sharded(run):
    """Under mesh= the lowered tree is the flat GLA: every rank's one-node
    SumAgg tree run is bitwise its flat Q6 run."""
    for rank, res in enumerate(run["main"]):
        assert _bitwise(res["run_query q6 tree chunk"], res["run_query q6 chunk"]), rank


def test_collectives_are_counted(run):
    stats = [res["collectives"] for res in run["main"]]
    assert all(s["calls"] > 0 and s["bytes"] > 0 for s in stats)


@pytest.mark.parametrize("name", ["q6", "q1", "q6-scan"])
def test_pause_on_four_ranks_writes_the_single_process_envelope(run, name):
    gla, emit = {"q6": (_q6(), "kernel"), "q1": (_q1(), "kernel"),
                 "q6-scan": (_q6(), "chunk")}[name]
    sess = T.Session(_spec(gla, emit=emit), run["single"]["block"], device="cpu")
    for _ in range(PAUSE_AT):
        sess.step()
    path = run["tmp"] / f"single-{name}.ckpt"
    sess.pause(path)
    meta1, blob1 = ckpt.load_envelope(path)
    meta4, blob4 = ckpt.load_envelope(run["tmp"] / "main" / f"{name}.ckpt")
    for k in ("elapsed_s",):
        meta1.pop(k), meta4.pop(k)
    assert meta4 == meta1
    like = sess._payload_like(PAUSE_AT)
    assert _bitwise(ckpt.deserialize_state(blob4, like), ckpt.deserialize_state(blob1, like))


@pytest.mark.parametrize("name", ["q6", "q1", "q6-scan"])
def test_resume_on_two_ranks_and_in_one_process(run, name):
    gla, emit = {"q6": (_q6(), "kernel"), "q1": (_q1(), "kernel"),
                 "q6-scan": (_q6(), "chunk")}[name]
    data = run["single"]["block"]
    ck = run["tmp"] / "main" / f"{name}.ckpt"
    whole = _drive(T.Session(_spec(gla, emit=emit), data, device="cpu"))
    here = _drive(T.Session.resume(ck, gla, data, device="cpu"))
    assert _bitwise(here, whole)
    elastic = _drive(T.Session.resume(ck, gla, data, partitions=4, device="cpu"))
    for res in run["resume"]:
        assert _bitwise(res[f"{name} partitions=None"], whole)
        got = res[f"{name} partitions=4"]
        assert _bitwise(got, elastic)
        np.testing.assert_allclose(got.final.numpy(), whole.final.numpy(), rtol=1e-6)
        assert torch.equal(got.snapshots.scanned, whole.snapshots.scanned)
        assert torch.equal(got.snapshots.matched, whole.snapshots.matched)


def test_a_rank_that_raises_stops_every_rank_at_once(run):
    res = run["raise"]
    assert "disk gone under this rank" in res[2]["error"]
    for rank in (0, 1, 3):
        assert "ranks [2] of the partition group failed" in res[rank]["error"]
    assert all(r["steps"] == 2 for r in res)
    assert max(r["seconds"] for r in res) < TIMEOUT / 2


def test_four_ranks_hold_to_the_reference_vmapped_run(run, ref_shards):
    g = RG.make_sum_gla(RT.q6_func, RT.q6_cond(RT.Q6_LOW_WINDOW), d_total=float(ROWS))
    ref = RE.run_query(g, ref_shards, rounds=ROUNDS)
    for res in run["main"]:
        got = res["run_query q6 chunk"]
        np.testing.assert_allclose(got.estimates.estimate.numpy(),
                                   np.asarray(ref.estimates.estimate), rtol=2e-5)
        np.testing.assert_allclose(float(got.final), float(ref.final), rtol=2e-5)


def test_live_row_sums_make_no_float64_copy_of_the_mask(monkeypatch, ref_shards):
    """engine._run_vmapped, scan._live and fused_agg._live_counts sum each
    chunk in float32 and widen only the [P, C] counts."""
    shards = {k: torch.from_numpy(v.copy()) for k, v in ref_shards.items()}
    mask = shards["_mask"]
    seen = []
    orig = torch.Tensor.sum

    def spy(self, *args, **kwargs):
        seen.append((self.numel(), kwargs.get("dtype")))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "sum", spy)
    counts = TFA._live_counts(mask)
    live = TSC._live(mask)
    res = T.run_query(_spec(_q1(), emit="round"), shards, device="cpu")
    monkeypatch.undo()
    assert all(not (n >= mask.numel() and dt == torch.float64) for n, dt in seen), seen
    assert any(n == mask.numel() and dt == torch.float32 for n, dt in seen)
    exact = mask.numpy().astype(np.float64).sum(axis=2)
    assert counts.dtype == torch.float64 and np.array_equal(counts.numpy(), exact)
    assert np.array_equal(live.numpy(), exact.sum(axis=1).astype(np.float32))
    assert np.array_equal(res.d_local.numpy(), exact.sum(axis=1).astype(np.float32))
