"""The port's span and counter recorder (``repro_torch.obs``): off, a span is
one shared object and reads no clock; on, nesting, parents, pass ids and
self times; the spans one ``run_queries`` bundle and one served query
leave; the sync counter; the spans as host-only ranges of a profile."""
import asyncio
import functools
import warnings

import pytest
import torch

import repro_torch as T
from repro_torch import obs
from repro_torch import service as SV
from repro_torch.data import tpch as TT
from repro_torch.randomize import pack_partitions, randomize_global

ROWS, PARTS, CHUNK = 4096, 4, 128  # C = 8 chunks a partition


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


@functools.lru_cache(maxsize=None)
def _table():
    cols = TT.generate_lineitem(ROWS, seed=1, device="cpu")
    g = torch.Generator().manual_seed(3)
    return pack_partitions(randomize_global(cols, g, PARTS), chunk_len=CHUNK)


def _bundle():
    """[scalar, group, scalar]: Q6, Q1's sum by returnflag × linestatus, a quantity sum."""
    q6 = T.make_sum_gla(TT.q6_func, TT.q6_cond(TT.Q6_LOW_WINDOW), d_total=float(ROWS))
    q1 = T.make_groupby_gla(TT.q6_func, lambda c: c["discount"] >= 0.0, TT.q1_group_small,
                            num_groups=4, d_total=float(ROWS))
    qty = T.make_sum_gla(lambda c: c["quantity"], lambda c: c["discount"] < 0.05,
                         d_total=float(ROWS))
    return [q6, q1, qty]


class _Clock:
    """perf_counter_ns stand-in: 10 ns a read."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 10
        return self.t


@pytest.mark.parametrize("make", [
    lambda: obs.span("pfola.merge"),
    lambda: obs.span("pfola.round", r=3),
    lambda: obs.root("pfola.pass"),
], ids=["span", "span-with-attrs", "root"])
def test_off_a_span_is_one_shared_object_and_reads_no_clock(make, monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with recording off")

    monkeypatch.setattr(obs.time, "perf_counter_ns", no_clock)
    a, b = make(), make()
    assert a is b is obs.OFF
    with a as s:
        s.note(queries=[1])
        obs.count(obs.SYNC)
    assert obs.begin("pfola.query") is None
    obs.end(None)
    s = obs.summary()
    assert s["spans"] == {} and s["counters"] == {} and s["records"] == 0
    assert obs.records() == []


@pytest.mark.parametrize("passes", [1, 3])
def test_on_nesting_parents_pass_ids_and_self_times(passes, monkeypatch):
    monkeypatch.setattr(obs.time, "perf_counter_ns", _Clock())
    with obs.recording():
        assert obs.span("pfola.scan") is not obs.OFF
        for _ in range(passes):
            with obs.root("pfola.pass"):  # t 10 .. 80
                with obs.span("pfola.scan"):  # 20 .. 50
                    with obs.span("pfola.round", r=0):  # 30 .. 40
                        pass
                with obs.span("pfola.merge"):  # 60 .. 70
                    pass
        with obs.span("pfola.serve.step") as sp:  # outside every pass
            sp.note(live=2)
    assert obs.span("pfola.scan") is obs.OFF
    recs = obs.records()
    assert [r.name for r in recs] == ["pfola.round", "pfola.scan", "pfola.merge",
                                     "pfola.pass"] * passes + ["pfola.serve.step"]
    by_id = {r.id: r for r in recs}
    groups = set()
    for i in range(passes):
        rnd, scan, merge, pas = recs[4 * i:4 * i + 4]
        assert pas.parent == 0 and pas.group == pas.id
        assert scan.parent == merge.parent == pas.id and rnd.parent == scan.id
        assert {rnd.group, scan.group, merge.group} == {pas.id}
        assert rnd.attrs == {"r": 0} and by_id[rnd.parent] is scan
        assert (pas.end_ns - pas.start_ns, pas.self_ns) == (70, 70 - 30 - 10)
        assert (scan.end_ns - scan.start_ns, scan.self_ns) == (30, 20)
        assert rnd.self_ns == merge.self_ns == 10
        groups.add(pas.id)
    assert len(groups) == passes
    step = recs[-1]
    assert step.parent == step.group == 0 and step.attrs == {"live": 2}
    s = obs.summary()["spans"]
    assert s["pfola.pass"] == {"count": passes, "total_ns": 70 * passes, "self_ns": 30 * passes}
    assert s["pfola.scan"]["self_ns"] == 20 * passes


@pytest.mark.parametrize("rounds", [2, 4])
def test_one_run_queries_bundle_leaves_its_spans(rounds):
    spec = T.QuerySpec(_bundle(), rounds=rounds, emit="kernel")
    with obs.recording():
        res = T.run_queries(spec, _table(), device="cpu")
    assert len(res) == 3 and res[1].final.shape[0] == 4
    s = obs.summary()["spans"]
    want = {"pfola.pass": 1, "pfola.session.init": 1, "pfola.scan": 1,
            "pfola.round": rounds, "pfola.project": 3 * rounds, "pfola.kernel": rounds,
            "pfola.merge": 1, "pfola.estimate": 1, "pfola.sync.weights": 1,
            "pfola.sync.d_copy": 3, "pfola.sync.zq": 3}
    assert {k: v["count"] for k, v in s.items()} == want
    recs = obs.records()
    pas = next(r for r in recs if r.name == "pfola.pass")
    assert {r.group for r in recs} == {pas.id}
    assert sorted(r.attrs["r"] for r in recs if r.name == "pfola.round") == list(range(rounds))
    assert [r.attrs["member"] for r in recs if r.name == "pfola.project"] == [0, 1, 2] * rounds
    assert {r.attrs["kernel"] for r in recs if r.name == "pfola.kernel"} == {"bundle"}
    for k, v in s.items():
        assert 0 <= v["self_ns"] <= v["total_ns"], k
    # the pass covers its children: their totals fit inside its duration
    kids = sum(s[k]["total_ns"] for k in ("pfola.session.init", "pfola.scan", "pfola.merge"))
    assert kids + s["pfola.pass"]["self_ns"] == s["pfola.pass"]["total_ns"]
    # a second pass, off, records nothing more
    T.run_queries(spec, _table(), device="cpu")
    assert obs.summary()["spans"]["pfola.pass"]["count"] == 1


def test_a_served_query_is_one_span_from_submit_to_result():
    fam = T.SlotFamily(exprs={"q6": TT.q6_func}, pred_cols=("shipdate",),
                       groups={"rfls": (TT.q1_group_small, 4)})
    q = T.SlotQuery("q6", {"shipdate": (420.0, 785.0)})

    async def main():
        async with SV.OLAService(fam, rounds=4, device="cpu") as svc:
            hs = [await svc.submit(q, _table()) for _ in range(2)]
            return [await h.result() for h in hs], hs

    with obs.recording():
        outs, hs = asyncio.run(asyncio.wait_for(main(), 60))
    assert all(o.rounds_witnessed == 4 for o in outs)
    recs = obs.records()
    queries = [r for r in recs if r.name == "pfola.query"]
    assert sorted(r.id for r in queries) == sorted(h._span.id for h in hs)
    assert all(r.group == r.id and r.self_ns == r.end_ns - r.start_ns for r in queries)
    steps = [r for r in recs if r.name == "pfola.serve.step"]
    seen = [i for st in steps for i in st.attrs["queries"]]
    for r in queries:  # each query advanced in 4 steps, inside its span
        mine = [st for st in steps if r.id in st.attrs["queries"]]
        assert len(mine) == 4 == seen.count(r.id)
        assert all(r.start_ns <= st.start_ns and st.end_ns <= r.end_ns for st in mine)
    assert all(st.attrs["live"] == len(st.attrs["queries"]) for st in steps)


@pytest.mark.parametrize("where", ["innermost", "outside", "other-warning"])
def test_the_sync_counter(where):
    with obs.recording():
        if where == "innermost":
            with obs.root("pfola.pass"), obs.span("pfola.merge"):
                warnings.warn(obs.SYNC_WARNING + " (Triggered internally)", UserWarning)
                warnings.warn(obs.SYNC_WARNING, UserWarning)
            with obs.span("pfola.round", r=0):
                warnings.warn(obs.SYNC_WARNING, UserWarning)
        elif where == "outside":
            with pytest.warns(UserWarning, match="synchronizing"):
                warnings.warn(obs.SYNC_WARNING, UserWarning)
        else:
            with obs.span("pfola.merge"), pytest.warns(UserWarning, match="another"):
                warnings.warn("another warning", UserWarning)
    s = obs.summary()
    if where == "innermost":
        assert s["counters"] == {obs.SYNC: 3}
        assert s["counters_by_span"] == {obs.SYNC: {"pfola.merge": 2, "pfola.round": 1}}
    else:
        assert s["counters"] == {} and s["counters_by_span"] == {}
    # the hooks are gone once the last span closed
    with pytest.warns(UserWarning, match="synchronizing"):
        warnings.warn(obs.SYNC_WARNING, UserWarning)


def test_under_a_profiler_spans_record_as_host_only_ranges():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec = T.QuerySpec(_bundle(), rounds=2, emit="kernel")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.run_queries(spec, _table(), device="cpu")
    assert obs.span("pfola.scan") is obs.OFF
    mine = [e for e in prof.events() if e.key.startswith("pfola.")]
    names = {e.key for e in mine}
    assert {"pfola.pass", "pfola.round", "pfola.project", "pfola.kernel", "pfola.merge"} <= names
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation for e in mine)
    s = obs.summary()["spans"]
    assert {k: s[k]["count"] for k in names} == {
        k: sum(e.key == k for e in mine) for k in names}


def test_threads_keep_their_own_nesting_and_no_total_is_lost():
    import os
    import sys
    import threading

    workers, n = 2 * (os.cpu_count() or 2), 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.recording():
            def work():
                for i in range(n):
                    with obs.root("pfola.pass"), obs.span("pfola.round", r=i):
                        obs.count("pfola.sync")

            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    s = obs.summary()
    assert s["spans"]["pfola.pass"]["count"] == s["spans"]["pfola.round"]["count"] == workers * n
    assert s["counters"] == {"pfola.sync": workers * n}
    assert s["counters_by_span"] == {"pfola.sync": {"pfola.round": workers * n}}
    recs = obs.records()
    passes = {r.id: r for r in recs if r.name == "pfola.pass"}
    assert len(passes) == workers * n  # ids are unique across threads
    for r in recs:
        if r.name == "pfola.round":
            assert r.parent in passes and r.group == r.parent
