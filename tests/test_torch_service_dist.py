"""Serving across processes (``repro_torch.OLAService(mesh=)``) on the CPU.

One gloo group of W=2 ranks, spawned once for the module under a file store
in ``tmp_path``, at ``test_torch_service.py``'s size (8,192 rows, P=4, L=128,
8 rounds) and family.  The ranks meet through a file barrier first, so the
group's timeout can be short: 5 s.  Rank 0 runs ``OLAService(mesh=)`` over a
fixed schedule — a query that converges early, a full pass, a group and a
HAVING slot, a cancel, a park through an idle gap longer than the group's
timeout, three bad queries while parked and an un-park — and rank 1 runs
``follow``.  Each rank records its service's operation log and a digest of
its scan after every step.  Then two more services on the same group fail:
a stopping rule that raises at round 2 (the step raises on every rank at
once) and an attach that raises on rank 0 alone, outside any step.

Held here: the two logs are equal, and so are the two ranks' digests at
every step; every outcome (estimate, lower, upper, ``scanned``, rounds
witnessed) is bitwise that of a one-process ``SharedScan`` replaying rank 0's
log over the whole table, step for step; the reference's vmapped
``SharedScan`` driven by the same log on the same shards agrees within
``test_torch_service.py``'s tolerances (counters exact, f32 estimates rtol
1e-5 with atol 1e-5·max|ref|, half-widths rtol 1e-3); ``submit`` on rank 1
raises, naming the follow loop; a bad query raises at ``submit`` and reaches
no rank; each failure resolves rank 0's handle with its error, closes the
service, and ends the follower's ``follow`` with an error.
"""
import asyncio
import functools
import hashlib
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
from repro.core import gla as RG
from repro.core import randomize as RR
from repro.data import tpch as RT
from repro.serving import service as RSV
from repro_torch import convert
from repro_torch import service as SV
from repro_torch import sharded as SH
from repro_torch.data import tpch as TT

ROWS, PARTS, CHUNK, ROUNDS, WORLD = 8192, 4, 128, 8, 2
RTOL, HALF_RTOL = 1e-5, 1e-3
TIMEOUT = 5.0  # seconds a rank waits in a collective: shorter than the idle gap
IDLE_S = 7.0  # rank 0's gap between arrivals, past the grace period
GRACE_S = 0.2
JOIN_S = 90.0  # seconds the spawned ranks may take in all

Q_SCALAR = T.SlotQuery("q6", {"shipdate": (420.0, 785.0)})
Q_LATE = T.SlotQuery("qty", {"discount": (0.02, 0.08)})
Q_GROUP = T.SlotQuery("q6", {"shipdate": (100.0, 2000.0)}, group="rfls")
Q_HAVING = T.SlotQuery("qty", {"shipdate": (0.0, 1500.0)}, group="rfls", having=4.0e5)
#: the schedule's queries in the order rank 0 attaches them (their op ids),
#: and the stopping rules of those that have one
QUERIES = (Q_SCALAR, Q_LATE, Q_GROUP, Q_HAVING, Q_SCALAR)
STOP_EPS = {0: 0.9}
#: an unknown expression, group and predicate column
BAD_QUERIES = (T.SlotQuery("nope"), T.SlotQuery("q6", group="nope"),
               T.SlotQuery("q6", {"nope": (0.0, 1.0)}))


@functools.lru_cache(maxsize=None)
def _packed():
    cols = RT.generate_lineitem(ROWS, seed=1)
    data = {k: jnp.asarray(v) for k, v in cols.items()}
    shards = RR.randomize_global(data, jax.random.key(9), PARTS)
    return {k: np.asarray(v) for k, v in RR.pack_partitions(shards, chunk_len=CHUNK).items()}


def _shards():
    return convert.shards_from_reference(_packed(), device="cpu")


def _family():
    return T.SlotFamily(
        exprs={"q6": TT.q6_func, "qty": lambda c: c["quantity"]},
        pred_cols=("shipdate", "discount"),
        groups={"rfls": (TT.q1_group_small, 4)})


def _ref_family():
    return RG.SlotFamily(
        exprs={"q6": RT.q6_func, "qty": lambda c: c["quantity"]},
        pred_cols=("shipdate", "discount"),
        groups={"rfls": (RT.q1_group_small, 4)})


def _digest(scan) -> str:
    """The scan's observable state: cursor, every bank's slot parameters and
    every attached slot's estimate bytes, ``scanned`` and rounds witnessed
    — equal on every rank (each holds the merged estimates)."""
    h = hashlib.sha256(str((scan.cursor, scan.steps_done)).encode())
    for name in sorted(scan.banks):
        b = scan.banks[name]
        for a in (b.expr, b.lo, b.hi, b.hv, b.generation):
            h.update(np.ascontiguousarray(a).tobytes())
        for rec in b.slots:
            if rec is None or rec.estimate is None:
                continue
            h.update(str((rec.slot, rec.scanned, len(rec.witnessed))).encode())
            for x in rec.estimate[:3]:
                h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _recording_steps(digests: list):
    """Wrap ``SharedScan.step`` (class level, in this process) to record the
    scan's digest after every step."""
    real = SV.SharedScan.step

    def step(self):
        out = real(self)
        digests.append(_digest(self))
        return out

    SV.SharedScan.step = step


def _outcome(est, scanned, rounds):
    return (tuple(x.detach().cpu().numpy().copy() for x in est[:3]), scanned, rounds)


async def _serve(svc, block):
    """Rank 0's schedule; the outcomes in QUERIES' order."""
    spec = lambda i: T.QuerySpec(QUERIES[i], stop=T.rel_width(STOP_EPS[i])) \
        if i in STOP_EPS else QUERIES[i]  # noqa: E731
    h = [await svc.submit(spec(i), block) for i in range(2)]
    await h[0].result()  # converges early; the full pass rides on
    h += [await svc.submit(spec(i), block) for i in (2, 3)]
    while not h[3].progress:  # cancel the HAVING slot after its first round
        await asyncio.sleep(0.001)
    svc.cancel(h[3])
    outs = [await x.result() for x in h]
    await asyncio.sleep(IDLE_S)  # parks, and idles past the group's timeout
    parked = svc.is_parked(block)
    scan = svc.scan_for(block)
    bad = []  # each raises here, and the follower waits on
    for q in BAD_QUERIES:
        try:
            await svc.submit(q, block)
        except KeyError as e:
            bad.append(str(e))
    still_parked = svc.is_parked(block)
    h.append(await svc.submit(spec(4), block))
    outs.append(await h[4].result())
    return {"outcomes": [_outcome(o.estimate, o.scanned, o.rounds_witnessed) for o in outs],
            "converged": [o.converged for o in outs], "parked": parked,
            "bad_submits": bad, "still_parked": still_parked,
            "same_scan": svc.scan_for(block) is scan, "steps": scan.steps_done,
            "stats": svc.mesh.stats()}


def _failing_rule(prog):
    if prog.round >= 2:
        raise ZeroDivisionError("the stopping rule failed at round 2")
    return False


def _failing_attach(self, q, stop=None):
    raise RuntimeError("attach failed on rank 0")


def _failures(rank, mesh, block):
    """Two services that fail, one after the other: rank 0 gets each
    handle's error and a later submit's; a follower how ``follow`` ended."""
    out = {}
    for name in ("every rank", "rank 0 alone"):
        svc = SV.OLAService(_family(), rounds=ROUNDS, grace_s=GRACE_S, mesh=mesh)
        if rank:
            try:
                svc.follow(block)
                out[name] = "returned"
            except Exception as e:
                out[name] = f"{type(e).__name__}: {e}"
            continue

        async def main(svc=svc):
            async with svc:
                h = await svc.submit(T.QuerySpec(Q_SCALAR, stop=_failing_rule), block)
                try:
                    await h.result()
                    got = "resolved"
                except Exception as e:
                    got = f"{type(e).__name__}: {e}"
                try:
                    await svc.submit(Q_SCALAR, block)
                    return got, "served"
                except RuntimeError as e:
                    return got, str(e)

        real = SV.SharedScan.attach
        if name == "rank 0 alone":  # in this process only
            SV.SharedScan.attach = _failing_attach
        try:
            out[name] = asyncio.run(asyncio.wait_for(main(), JOIN_S))
        finally:
            SV.SharedScan.attach = real
    return out


def _rank_main(rank, store, out_dir):
    torch.set_num_threads(1)
    out = Path(out_dir) / f"{rank}.pkl"
    try:
        # meet first, so the short collective timeout never covers start-up
        Path(out_dir, f"ready-{rank}").touch()
        t0 = time.monotonic()
        while not all(Path(out_dir, f"ready-{r}").exists() for r in range(WORLD)):
            if time.monotonic() - t0 > JOIN_S:
                raise TimeoutError("the other rank never started")
            time.sleep(0.01)
        mesh = SH.init_partition_group("gloo", f"file://{store}", rank, WORLD, "cpu",
                                       timeout=TIMEOUT)
        digests = []
        _recording_steps(digests)
        try:
            lo, hi = mesh.bounds(PARTS)
            block = {k: v[lo:hi] for k, v in _shards().items()}
            svc = SV.OLAService(_family(), rounds=ROUNDS, grace_s=GRACE_S, mesh=mesh)
            if rank == 0:
                async def main():
                    async with svc:
                        return await _serve(svc, block)

                res = asyncio.run(asyncio.wait_for(main(), JOIN_S))
            else:
                with_msg = None
                try:
                    asyncio.run(svc.submit(Q_SCALAR, block))
                except RuntimeError as e:
                    with_msg = str(e)
                t0 = time.monotonic()
                svc.follow(block)
                res = {"submit_error": with_msg, "follow_s": time.monotonic() - t0}
            res.update(log=svc.op_log, digests=list(digests))
            res["failures"] = _failures(rank, mesh, block)
        finally:
            mesh.close()
        out.write_bytes(pickle.dumps(("ok", res)))
    except BaseException:
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("service_dist")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp / "store"), str(tmp)),
                         daemon=True) for r in range(WORLD)]
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
    out = []
    for r in range(WORLD):
        f = tmp / f"{r}.pkl"
        assert f.exists(), f"rank {r} wrote nothing (exit code {procs[r].exitcode})"
        status, res = pickle.loads(f.read_bytes())
        assert status == "ok", f"rank {r} failed:\n{res}"
        out.append(res)
    return out


def _replay(scan, log, steps, attach, on_step=None):
    """Drive ``scan`` by ``log`` — before step s, the operations logged at
    ``steps_done == s``, in order — for ``steps`` steps, detaching every
    slot a step completes, as the service does.  Returns {op id: record}."""
    recs = {}
    for s in range(steps + 1):
        for at, op in log:
            if at != s:
                continue
            if op["op"] == "attach":
                recs[op["id"]] = attach(scan, op["id"])
            else:
                scan.detach(recs[op["id"]])
        if s == steps:
            break
        out = scan.step()
        assert out, f"the replay has no live slot at step {s}"
        if on_step is not None:  # where the ranks' digests are taken
            on_step(scan)
        for rec, _ in out:
            if rec.done:
                scan.detach(rec)
    return recs


def _port_attach(scan, i):
    stop = T.rel_width(STOP_EPS[i]) if i in STOP_EPS else None
    return scan.attach(QUERIES[i], stop)


def test_every_rank_applies_one_log_and_holds_one_state_each_step(ranks):
    r0, r1 = ranks
    assert r0["log"] == r1["log"]
    kinds = [op["op"] for _, op in r0["log"]]
    assert kinds.count("attach") == len(QUERIES) and kinds.count("detach") == 1
    assert len(r0["digests"]) == len(r1["digests"]) == r0["steps"] > ROUNDS
    assert r0["digests"] == r1["digests"]
    assert r0["stats"]["calls"] > 0 and r0["stats"]["bytes"] > 0


def test_every_outcome_bitwise_a_one_process_replay_of_the_log(ranks):
    r0 = ranks[0]
    digests = []
    scan = SV.SharedScan(_family(), _shards(), rounds=ROUNDS, device="cpu")
    recs = _replay(scan, r0["log"], r0["steps"], _port_attach,
                   lambda s: digests.append(_digest(s)))
    assert digests == r0["digests"]
    for i, got in enumerate(r0["outcomes"]):
        rec = recs[i]
        want = _outcome(rec.estimate, rec.scanned, len(rec.witnessed))
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got[0], want[0])), i
        assert got[1:] == want[1:], i
    # the schedule did what it says: an early convergence, a full pass, a
    # cancel after one round and a full pass after the un-park
    rounds = [o[2] for o in r0["outcomes"]]
    assert r0["converged"][0] and rounds[0] < ROUNDS
    assert rounds[1] == rounds[2] == rounds[4] == ROUNDS and 1 <= rounds[3] < ROUNDS
    assert r0["parked"] and r0["same_scan"]


def test_the_reference_driven_by_the_same_log_agrees(ranks, monkeypatch):
    r0 = ranks[0]
    witnessed = [o[2] for o in r0["outcomes"]]
    # The reference's step dispatches on its bank's numpy parameter rows and
    # clears their ``fresh`` flags as soon as the call returns; on the CPU,
    # jax may read those rows in place after that, so a slot attached at the
    # step can lose its fresh start (its group estimates then vary from run
    # to run on one log).  Each step here waits for its result first.
    real = RSV.serve_step_vmapped
    monkeypatch.setattr(RSV, "serve_step_vmapped",
                        lambda *a, **k: jax.block_until_ready(real(*a, **k)))

    def attach(scan, i):
        q = QUERIES[i]
        # the port's rule stopped this slot after its rounds: so does this one
        stop = (lambda prog, n=witnessed[i]: prog.round >= n) if i in STOP_EPS else None
        return scan.attach(RG.SlotQuery(q.expr, dict(q.ranges), q.group, q.having), stop)

    packed = {k: jnp.asarray(v) for k, v in _packed().items()}
    recs = _replay(RSV.SharedScan(_ref_family(), packed, rounds=ROUNDS), r0["log"],
                   r0["steps"], attach)
    for i, (est, scanned, rounds) in enumerate(r0["outcomes"]):
        rec = recs[i]
        assert (scanned, rounds) == (rec.scanned, len(rec.witnessed)), i
        want = rec.estimate
        for got, ref, rtol in ((est[0], want.estimate, RTOL),
                               ((est[2] - est[1]) / 2, (np.asarray(want.upper)
                                                        - np.asarray(want.lower)) / 2,
                                HALF_RTOL)):
            ref = np.asarray(ref, np.float64)
            fin = np.isfinite(ref)
            np.testing.assert_allclose(got.astype(np.float64)[fin], ref[fin], rtol=rtol,
                                       atol=rtol * np.abs(ref[fin]).max(initial=0.0),
                                       err_msg=str(i))


def test_submit_on_a_follower_raises_naming_the_follow_loop(ranks):
    assert "runs on rank 0" in ranks[1]["submit_error"]
    assert "follow(data)" in ranks[1]["submit_error"]


def test_a_follower_waits_through_an_idle_gap_past_the_group_timeout(ranks):
    assert IDLE_S > TIMEOUT
    assert ranks[1]["follow_s"] > IDLE_S  # it followed across the gap, and ended cleanly


def test_a_bad_query_after_a_park_raises_at_submit_and_reaches_no_rank(ranks):
    r0, r1 = ranks
    assert r0["bad_submits"] == ["\"unknown expression 'nope'; family basis is ['q6', 'qty']\"",
                                 "\"unknown group key 'nope'; family has ['rfls']\"",
                                 "\"query constrains ['nope'], not in the family's pred_cols "
                                 "['shipdate', 'discount']\""]
    assert r0["still_parked"]
    assert all(op["query"][0] in ("q6", "qty") for _, op in r1["log"] if op["op"] == "attach")


def test_a_step_failing_on_every_rank_ends_every_follow(ranks):
    r0, r1 = ranks
    assert r0["failures"]["every rank"] == (
        "ZeroDivisionError: the stopping rule failed at round 2", "service is closed")
    assert r1["failures"]["every rank"] == (
        "RuntimeError: rank 0 of the partition group failed evaluating the stopping rule")


def test_a_failure_on_rank_0_alone_ends_every_follow(ranks):
    r0, r1 = ranks
    assert r0["failures"]["rank 0 alone"] == (
        "RuntimeError: attach failed on rank 0", "service is closed")
    assert r1["failures"]["rank 0 alone"] == (
        "RuntimeError: rank 0's service failed: RuntimeError: attach failed on rank 0")
