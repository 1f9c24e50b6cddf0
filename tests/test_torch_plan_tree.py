"""Plan trees in the port (``repro_torch.spec``): PlanNode lowering onto the
port's GLA constructors, the QuerySpec integration, and the refusals.

The port of ``tests/test_plan_tree.py`` (its three C010 linter tests stay the
reference's; the sharded flat-vs-tree case is in ``test_torch_sharded.py``).
Shards are built once with the reference's generator and randomizer and
converted with ``repro_torch.convert``.

Tolerances: within the port a one-node tree is bitwise its flat GLA (finals,
snapshots, bounds) on ``emit="chunk"`` and ``"kernel"`` (the kernels' plain
versions here).  Port trees against the reference's trees (its
``emit="chunk"`` scan, the reference's oracle as in ``test_torch_engine.py``):
counters exact, sums, estimates and bounds at ``SUM_RTOL`` = 1e-5 with
atol = 1e-5·max|ref| (the summation order differs).  Two stacked Filters
against one combined predicate: rtol 1e-6, as the reference's test.
Refusals: the port's message is the reference's, word for word.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as T
from repro.core import engine as REN
from repro.core import randomize as RR
from repro.core import spec as RS
from repro.data import tpch as RT
from repro_torch import convert
from repro_torch import gla as TG
from repro_torch import spec as TS
from repro_torch.data import tpch as TT
from repro_torch.uda import tree_map

SRC = str(Path(__file__).resolve().parents[1] / "src")
ROWS = 12_000
PARTS = 4
D = float(ROWS)
ROUNDS = 4
SUM_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref_shards():
    cols = RT.generate_lineitem(ROWS, seed=23)
    cols["orderkey"] = RT.generate_orders_fk(ROWS, seed=7)
    parts = RR.randomize_global(
        {k: jnp.asarray(v) for k, v in cols.items()}, jax.random.key(5), PARTS)
    return RR.pack_partitions(parts, chunk_len=256)


@pytest.fixture(scope="module")
def shards(ref_shards):
    return convert.shards_from_reference(
        {k: np.asarray(v) for k, v in ref_shards.items()}, device="cpu")


@pytest.fixture(scope="module")
def orders():
    return RT.orders_table(max(1, ROWS // 4), seed=14)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def leaves_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _run(gla_or_tree, shards, emit="chunk"):
    return T.run_query(T.QuerySpec(gla_or_tree, rounds=ROUNDS, emit=emit), shards,
                       device="cpu")


def assert_same_run(flat, tree, shards, emit):
    """Flat GLA vs lowered tree: finals, snapshots and bounds bitwise."""
    a, b = _run(flat, shards, emit), _run(tree, shards, emit)
    assert leaves_equal(a.final, b.final)
    assert leaves_equal(a.snapshots, b.snapshots)
    assert leaves_equal(
        (a.estimates.estimate, a.estimates.lower, a.estimates.upper),
        (b.estimates.estimate, b.estimates.lower, b.estimates.upper))
    return b


def _close(got, want, what):
    a = got.detach().numpy().astype(np.float64)
    b = np.asarray(want, np.float64)
    assert a.shape == b.shape, what
    assert np.array_equal(np.isinf(a), np.isinf(b)), what
    fin = np.isfinite(b)
    atol = SUM_RTOL * np.abs(b[fin]).max(initial=0.0)
    np.testing.assert_allclose(a[fin], b[fin], rtol=SUM_RTOL, atol=atol, err_msg=what)


def assert_matches_reference(got, ref_tree, ref_shards):
    """A port tree's run against the reference tree's ``emit="chunk"`` run."""
    want = REN.run_query(RS.QuerySpec(ref_tree, rounds=ROUNDS, emit="chunk"),
                         ref_shards)
    _close(got.final, want.final, "final")
    for f in ("scanned", "matched"):
        np.testing.assert_array_equal(getattr(got.snapshots, f).numpy(),
                                      np.asarray(getattr(want.snapshots, f)), err_msg=f)
    for f in ("sum", "sumsq"):
        _close(getattr(got.snapshots, f), getattr(want.snapshots, f), f)
    for f in ("estimate", "lower", "upper"):
        _close(getattr(got.estimates, f), getattr(want.estimates, f), f)


# ---------------------------------------------------------------------------
# flat plans through one-node trees: bitwise-identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("emit", ["chunk", "kernel"])
def test_flat_sum_lowers_bitwise(shards, ref_shards, emit):
    """SumAgg(Filter(Scan)) with the same cond closure the flat spelling
    uses lowers to the same make_sum_gla call."""
    cond = TT.q6_cond(TT.Q6_LOW_WINDOW)
    flat = T.make_sum_gla(TT.q6_func, cond, d_total=D)
    tree = T.SumAgg(T.Filter(T.Scan(D), cond), TT.q6_func)
    got = assert_same_run(flat, tree, shards, emit)
    assert_matches_reference(
        got, RS.SumAgg(RS.Filter(RS.Scan(D), RT.q6_cond(RT.Q6_LOW_WINDOW)),
                       RT.q6_func), ref_shards)


@pytest.mark.parametrize("emit", ["chunk", "kernel"])
def test_flat_groupby_lowers_bitwise(shards, ref_shards, emit):
    flat = T.make_groupby_gla(
        TT.q1_func, TT.q1_cond, TT.q1_group_small, num_groups=4,
        d_total=D, num_aggs=4)
    tree = T.GroupAgg(T.Filter(T.Scan(D), TT.q1_cond), TT.q1_func,
                      num_groups=4, group=TT.q1_group_small, num_aggs=4)
    got = assert_same_run(flat, tree, shards, emit)
    assert_matches_reference(
        got, RS.GroupAgg(RS.Filter(RS.Scan(D), RT.q1_cond), RT.q1_func,
                         num_groups=4, group=RT.q1_group_small, num_aggs=4),
        ref_shards)


@pytest.mark.parametrize("emit", ["chunk", "kernel"])
def test_join_tree_lowers_bitwise(shards, ref_shards, orders, emit):
    """GroupAgg over a Join stage lowers to make_join_groupby_gla with the
    same probe arrays and closures — a bitwise-identical run.  The Join
    node's ``device`` places the probe tables."""
    segment, valid = orders
    flat = T.make_join_groupby_gla(
        TT.q6_func, TT.q1_cond, TT.orderkey, segment, valid,
        num_groups=TT.NUM_SEGMENTS, d_total=D, device="cpu")
    tree = T.GroupAgg(
        T.Join(T.Filter(T.Scan(D), TT.q1_cond), TT.orderkey, segment, valid,
               device="cpu"),
        TT.q6_func, num_groups=TT.NUM_SEGMENTS)
    got = assert_same_run(flat, tree, shards, emit)
    assert_matches_reference(
        got, RS.GroupAgg(
            RS.Join(RS.Filter(RS.Scan(D), RT.q1_cond), lambda c: c["orderkey"],
                    segment, valid),
            RT.q6_func, num_groups=RT.NUM_SEGMENTS), ref_shards)


def test_join_node_places_probe_tables_on_its_device(orders):
    segment, valid = orders
    g = T.lower_plan(T.GroupAgg(
        T.Join(T.Scan(D), TT.orderkey, segment, valid, device="cpu"),
        TT.q6_func, num_groups=TT.NUM_SEGMENTS))
    assert all(pt.values.device.type == "cpu" for pt in g.fused.probe_tables)
    assert T.Join(T.Scan(D), TT.orderkey, segment, valid).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            T.lower_plan(T.GroupAgg(T.Join(T.Scan(D), TT.orderkey, segment, valid),
                                    TT.q6_func, num_groups=TT.NUM_SEGMENTS))


def test_multi_filter_conjunction(shards, ref_shards):
    """Stacked Filter stages conjoin multiplicatively — the same result as a
    single combined predicate (allclose: the combined closure differs)."""
    lo, hi = TT.Q6_LOW_WINDOW

    def c_lo(c):
        return (c["shipdate"] >= lo).to(torch.float32)

    def c_hi(c):
        return (c["shipdate"] < hi).to(torch.float32)

    def c_both(c):
        return c_lo(c) * c_hi(c)

    tree = T.SumAgg(T.Filter(T.Filter(T.Scan(D), c_lo), c_hi), TT.q6_func)
    flat = T.make_sum_gla(TT.q6_func, c_both, d_total=D)
    a, b = _run(flat, shards), _run(tree, shards)
    np.testing.assert_allclose(a.final.numpy(), b.final.numpy(), rtol=1e-6)


def test_cond_true_of_a_filterless_tree(shards):
    """A SumAgg straight over the Scan lowers with an all-ones predicate:
    every live row matches."""
    res = _run(T.SumAgg(T.Scan(D), TT.q6_func), shards)
    assert torch.equal(res.snapshots.matched, res.snapshots.scanned)


# ---------------------------------------------------------------------------
# QuerySpec integration
# ---------------------------------------------------------------------------

def test_queryspec_lowers_tree_and_keeps_provenance():
    tree = T.SumAgg(T.Filter(T.Scan(D), TT.q1_cond), TT.q6_func)
    qs = T.QuerySpec(tree, rounds=4)
    assert qs.plan is tree
    assert qs.gla.estimate is not None  # a lowered, runnable GLA
    assert not isinstance(qs.gla, T.PlanNode)
    assert qs.with_(rounds=8).plan is tree  # replace keeps the provenance


def test_queryspec_lowers_sequences_mixing_trees_and_glas():
    tree = T.SumAgg(T.Filter(T.Scan(D), TT.q1_cond), TT.q6_func)
    flat = T.make_sum_gla(TT.q6_func, TT.q1_cond, d_total=D)
    qs = T.QuerySpec([tree, flat], rounds=4)
    assert qs.is_multi and len(qs.gla) == 2
    assert qs.gla[1] is flat  # GLAs pass through untouched
    assert qs.plan == [tree, flat]
    assert isinstance(T.QuerySpec((tree, flat)).gla, tuple)


def test_run_queries_of_trees_bitwise_their_flat_bundle(shards):
    """run_queries over a sequence of trees is the flat GLAs' bundle run."""
    cond = TT.q6_cond(TT.Q6_LOW_WINDOW)
    flat = [T.make_sum_gla(TT.q6_func, cond, d_total=D),
            T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small,
                               num_groups=4, d_total=D, num_aggs=4)]
    trees = [T.SumAgg(T.Filter(T.Scan(D), cond), TT.q6_func),
             T.GroupAgg(T.Filter(T.Scan(D), TT.q1_cond), TT.q1_func, num_groups=4,
                        group=TT.q1_group_small, num_aggs=4)]
    for emit in ("round", "kernel"):
        a = T.run_queries(T.QuerySpec(flat, rounds=ROUNDS, emit=emit), shards,
                          device="cpu")
        b = T.run_queries(T.QuerySpec(trees, rounds=ROUNDS, emit=emit), shards,
                          device="cpu")
        for x, y in zip(a, b):
            assert leaves_equal((x.final, x.snapshots, x.estimates[:3]),
                                (y.final, y.snapshots, y.estimates[:3]))


def test_slot_query_is_not_a_sequence_of_plans():
    """A NamedTuple query description is one query, as in the reference:
    ``is_multi`` False and ``emit`` resolving to "chunk"."""
    for pkg in (RS, TS):
        assert not pkg._is_gla_sequence(T.SlotQuery("rev"))
        assert pkg._is_gla_sequence([T.SlotQuery("rev")])
    ref = RS.QuerySpec(repro.SlotQuery("rev", {"discount": (0.0, 1.0)}))
    port = T.QuerySpec(T.SlotQuery("rev", {"discount": (0.0, 1.0)}))
    assert port.is_multi is ref.is_multi is False
    assert port.resolved_emit() == ref.resolved_emit() == "chunk"


def test_plan_node_lower_method_matches_lower_plan(shards):
    tree = T.GroupAgg(T.Filter(T.Scan(D), TT.q1_cond), TT.q1_func,
                      num_groups=4, group=TT.q1_group_small, num_aggs=4)
    a, b = _run(tree.lower(), shards), _run(tree, shards)
    assert leaves_equal(a.final, b.final)


def test_having_tree_lowers_to_composed_gla(shards, ref_shards):
    tree = T.Having(
        T.GroupAgg(T.Filter(T.Scan(D), TT.q1_cond), TT.q6_func,
                   num_groups=4, group=TT.q1_group_small),
        threshold=10.0)
    g = T.lower_plan(tree)
    assert g.name.startswith("having[")
    res = _run(g, shards)
    est = res.estimates
    assert torch.isfinite(est.estimate).all()
    assert tuple(est.estimate.shape[-1:]) in ((), (4,), (ROUNDS,))
    ref = REN.run_query(RS.QuerySpec(RS.Having(
        RS.GroupAgg(RS.Filter(RS.Scan(D), RT.q1_cond), RT.q6_func, num_groups=4,
                    group=RT.q1_group_small), threshold=10.0),
        rounds=ROUNDS, emit="chunk"), ref_shards)
    for f in ("estimate", "lower", "upper"):
        _close(getattr(est, f), getattr(ref.estimates, f), f)


# ---------------------------------------------------------------------------
# lowering-rule violations fail at plan-build time, with the reference's
# messages
# ---------------------------------------------------------------------------

def _ctrue(c):
    return c["_mask"] * 0 + 1


def _jtree(pkg, child=None):
    seg = np.zeros(8, np.int32)
    val = np.ones(8, np.float32)
    return pkg.Join(child or pkg.Scan(D), _ctrue, seg, val)


def _refusal(pkg, build, exc=ValueError):
    with pytest.raises(exc) as e:
        pkg.lower_plan(build(pkg))
    return str(e.value)


REFUSALS = {
    "two join stages": (lambda m: m.GroupAgg(_jtree(m, _jtree(m)), None, num_groups=8),
                        "one Join stage"),
    "sum root over join": (lambda m: m.SumAgg(_jtree(m), None), "GroupAgg root"),
    "groupagg plain scan needs group": (
        lambda m: m.GroupAgg(m.Scan(D), None, num_groups=4), "needs group="),
    "groupagg over join rejects group": (
        lambda m: m.GroupAgg(_jtree(m), None, num_groups=8, group=_ctrue), "drop group="),
    "count distinct over join": (lambda m: m.CountDistinct(_jtree(m), _ctrue),
                                 "plain filtered scans"),
    "quantile over join": (lambda m: m.Quantile(_jtree(m), _ctrue, lo=0.0, hi=1.0),
                           "plain filtered scans"),
    "heavy hitters over join": (
        lambda m: m.HeavyHitters(_jtree(m), _ctrue, np.arange(4)), "plain filtered scans"),
    "nested estimator roots": (lambda m: m.SumAgg(m.SumAgg(m.Scan(D), None), None),
                               "below another root"),
    "non-root lowering": (lambda m: m.Filter(m.Scan(D), _ctrue), "not an estimator root"),
}


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
@pytest.mark.parametrize("case", list(REFUSALS))
def test_lowering_refusals_with_the_reference_messages(pkg, case):
    build, fragment = REFUSALS[case]
    got = _refusal({"repro": RS, "repro_torch": TS}[pkg], build)
    assert fragment in got
    assert got == _refusal(RS, build)


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_lowering_a_non_plan_is_a_type_error(pkg):
    m = {"repro": RS, "repro_torch": TS}[pkg]
    with pytest.raises(TypeError, match="PlanNode") as e:
        m.lower_plan("not a plan")
    with pytest.raises(TypeError, match="not a PlanNode") as e2:
        m.lower_plan(m.SumAgg("not a stage", None))
    with pytest.raises(TypeError) as r:
        RS.lower_plan("not a plan")
    assert str(e.value) == str(r.value)
    assert str(e2.value) == "not a PlanNode: 'not a stage'"


# ---------------------------------------------------------------------------
# the port's nodes declare what rule C010 asks, as the reference's
# ---------------------------------------------------------------------------

NODES = ("Scan", "Filter", "Join", "SumAgg", "GroupAgg", "Having",
         "CountDistinct", "Quantile", "HeavyHitters")


@pytest.mark.parametrize("name", NODES)
def test_nodes_declare_the_reference_monoid_and_estimator(name):
    port, ref = getattr(T, name), getattr(RS, name)
    assert issubclass(port, T.PlanNode)
    assert (vars(port)["monoid"], vars(port)["estimator"]) == \
        (vars(ref)["monoid"], vars(ref)["estimator"])
    ref_fields = [f.name for f in ref.__dataclass_fields__.values()]
    port_fields = [f.name for f in port.__dataclass_fields__.values()]
    # the port's Join alone adds where its probe tables go
    assert port_fields == ref_fields + (["device"] if name == "Join" else [])


def test_port_spec_module_lints_clean_of_c010():
    from repro.analysis import contracts

    path = Path(SRC) / "repro_torch" / "spec.py"
    assert not [v for v in contracts.lint_file(path, Path(SRC).parent)
                if v.code in ("C009", "C010")]


# ---------------------------------------------------------------------------
# facade: the names resolve, and building a tree needs no card
# ---------------------------------------------------------------------------

def test_building_a_tree_loads_no_jax():
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        import repro_torch as T
        tree = T.SumAgg(T.Filter(T.Scan(8.0), None), None)
        assert isinstance(tree, T.PlanNode)
        assert "PlanNode" in T.__all__ and "lower_plan" in T.__all__
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
        assert not bad, bad
        print("OK")
    """ % SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def test_facade_exports_resolve():
    for name in (*NODES, "PlanNode", "lower_plan", "compose", "make_having_gla",
                 "monotone_envelope", "make_count_distinct_gla",
                 "make_quantile_gla", "make_heavy_hitters_gla"):
        assert getattr(T, name) is not None and name in T.__all__
    assert T.lower_plan is TS.lower_plan and T.make_sum_gla is TG.make_sum_gla
