"""K3 bundles at each member's own shape (``ops.group_agg_bundle``,
``scan.bundle_round_deltas``), on the CPU's plain route: every member
bitwise its solo ``group_agg`` and the one-table launch that stacked every
member's groups (padded to the widest member, ids offset); the round fold
that folds each round-slice's deltas as they come, bitwise the fold of the
whole list and holding no more than one slice's deltas; the K3 path's
spans and the ``pfola.fold.visits`` counter.  The card's twins are in
``test_torch_kernels_gpu.py``."""
import functools
import weakref

import pytest
import torch

import repro_torch as T
from repro_torch import obs, scan
from repro_torch.data import tpch as TT
from repro_torch.kernels import _runtime as RT
from repro_torch.kernels import ops
from repro_torch.randomize import pack_partitions, randomize_global
from repro_torch.uda import tree_map, tree_stack

ROWS, PARTS, CHUNK, ROUNDS = 4096, 4, 128, 4  # C = 8 chunks a partition

#: (A, G) of each member: the report bundle's Q6 (one group), Q1 (4 groups
#: of 4 sums) and Q15 at a CPU's size; Q1 beside Q10's 15,000,000 customers
SHAPES = {"report": [(1, 1), (4, 4), (1, 1000)], "q10": [(4, 4), (1, 15_000_000)]}


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


def _member(seed, P, C, L, A, G):
    g = torch.Generator().manual_seed(seed)
    vals = torch.rand((P, C * L, A), generator=g) * 100
    w = (torch.rand((P, C * L), generator=g) < 0.5).float()
    gids = torch.randint(0, G, (P, C * L), generator=g, dtype=torch.int32)
    gids[:, :3] = torch.tensor([-1, G, G + 5], dtype=torch.int32)  # ids that drop out
    return vals, w, gids, G


def _one_table(members, L):
    """The launch the bundle path made before each member ran at its own
    shape: every member's rows one after another, values padded to the
    widest member, ids offset into one table of every member's groups (an
    id that drops out kept out)."""
    A_max = max(m[0].shape[-1] for m in members)
    vals, w, gids, off, offs = [], [], [], 0, []
    for v, ww, g, G in members:
        vals.append(torch.nn.functional.pad(v, (0, A_max - v.shape[-1])))
        w.append(ww)
        keep = (g >= 0) & (g < G)
        gids.append(torch.where(keep, g + off, -1))
        offs.append(off)
        off += G
    out = ops.group_agg(torch.cat(vals, 1), torch.cat(w, 1), torch.cat(gids, 1),
                        num_groups=off, block_rows=L)
    return [tuple(x[:, o:o + G] if i == 2 else x[:, o:o + G, :v.shape[-1]]
                  for i, x in enumerate(out))
            for o, (v, _, _, G) in zip(offs, members)]


@pytest.mark.parametrize("shapes", sorted(SHAPES))
def test_each_member_is_bitwise_its_solo_launch_and_the_one_table_launch(shapes):
    P, C, L = (2, 3, 64) if shapes == "report" else (1, 2, 64)
    members = [_member(i, P, C, L, A, G) for i, (A, G) in enumerate(SHAPES[shapes])]
    before = dict(RT.DISPATCHES)
    got = ops.group_agg_bundle(members, block_rows=L)
    assert RT.DISPATCHES["group_agg"] - before["group_agg"] == 1
    for m, out, stacked in zip(members, got, _one_table(members, L)):
        solo = ops.group_agg(*m[:3], num_groups=m[3], block_rows=L)
        assert all(torch.equal(a, b) for a, b in zip(out, solo))
        assert all(torch.equal(a, b) for a, b in zip(out, stacked))


def test_a_bundle_past_one_launch_takes_one_more():
    members = [_member(i, 2, 2, 32, 1, 3 + i) for i in range(ops.MAX_BUNDLE_MEMBERS + 1)]
    before = RT.DISPATCHES["group_agg"]
    got = ops.group_agg_bundle(members, block_rows=32)
    assert RT.DISPATCHES["group_agg"] - before == 2 and len(got) == len(members)
    assert all(torch.equal(a, b) for a, b in zip(
        got[-1], ops.group_agg(*members[-1][:3], num_groups=members[-1][3], block_rows=32)))


def test_members_of_other_rows_are_refused():
    a, b = _member(0, 2, 2, 32, 1, 3), _member(1, 2, 3, 32, 1, 3)
    with pytest.raises(ValueError, match="same"):
        ops.group_agg_bundle([a, b], block_rows=32)
    with pytest.raises(ValueError, match="one or more"):
        ops.group_agg_bundle([], block_rows=32)


def test_fold_visits_follow_each_members_own_windows():
    """At SF 100's round-slice (P = 8, 2,289 chunks of 2,048 rows) Q10's
    15,000,000 customers take windows of 1,024 ids; in one table with the
    report bundle's groups (16,000,007 rows at A = 4) every member's chunk
    would walk 62,501 windows of 256."""
    P, C, L = 8, 2289, 2048
    assert ops.group_step_span(L, 1, 15_000_000) == 32
    assert ops.group_step_visits(P, C, L, [(1, 15_000_000)]) == 8 * 14_649 * 2289
    one_table = ops.group_step_visits(P, 5 * C, L, [(4, 16_000_007)])
    assert one_table == 8 * 62_501 * 5 * 2289
    own = ops.group_step_visits(P, C, L, [(1, 1), (4, 4), (1, 1_000_000), (1, 15_000_000),
                                          (1, 2)])
    assert own == 8 * C * (1 + 1 + 977 + 14_649 + 1) and one_table > 19 * own


@functools.lru_cache(maxsize=None)
def _table():
    cols = TT.generate_lineitem(ROWS, seed=3, device="cpu")
    return pack_partitions(randomize_global(cols, torch.Generator().manual_seed(5), PARTS),
                           chunk_len=CHUNK)


def _legacy_bundle():
    """[Q6, Q1 by returnflag × linestatus, a sum by supplier] without their
    fused contracts: the bundle takes K3."""
    d = float(ROWS)
    q6 = T.make_sum_gla(TT.q6_func, TT.q6_cond(TT.Q6_LOW_WINDOW), d_total=d)
    q1 = T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small, num_groups=4,
                            d_total=d, num_aggs=4)
    supp = T.make_groupby_gla(TT.q6_func, TT.q1_cond, lambda c: c["suppkey"],
                              num_groups=1000, d_total=d)
    return T.GLABundle([g.with_(fused=None) for g in (q6, q1, supp)])


def _list_then_fold(fn, gla, cols, rounds):
    """Every round-slice's deltas first, then the running sum, as the K3
    paths folded them before they folded each slice as it returned."""
    C = cols["_mask"].shape[1]
    per = C // rounds
    deltas = [fn(gla, {k: v[:, r * per:(r + 1) * per] for k, v in cols.items()})
              for r in range(rounds)]
    acc, views = deltas[0], [deltas[0]]
    for d in deltas[1:]:
        acc = tree_map(torch.add, acc, d)
        views.append(acc)
    return acc, tree_stack(views, dim=1)


def _leaves(x):
    out = []
    tree_map(out.append, x)
    return out


@pytest.mark.parametrize("path", ["bundle", "group"])
def test_the_streaming_fold_is_bitwise_the_list_then_fold(path):
    b = _legacy_bundle()
    gla, fn, run = ((b, scan.bundle_round_deltas, scan.bundle_kernel_rounds_states)
                    if path == "bundle" else
                    (b.members[1], scan.kernel_round_delta, scan.kernel_rounds_states))
    got = run(gla, _table(), ROUNDS)
    want = _list_then_fold(fn, gla, _table(), ROUNDS)
    assert all(torch.equal(a, w) for a, w in zip(_leaves(got), _leaves(want)))


def test_the_streaming_fold_holds_no_more_than_one_slices_deltas(monkeypatch):
    """When a round-slice's deltas are computed, at most one earlier slice's
    deltas are alive: the running state, which is the first slice's until
    the second is added onto it."""
    real, alive = scan.bundle_round_deltas, []
    seen = []

    def spy(gla, sl):
        alive.append(sum(r() is not None for r in seen))
        out = real(gla, sl)
        seen.append(weakref.ref(out[1].sum))
        return out

    monkeypatch.setattr(scan, "bundle_round_deltas", spy)
    scan.bundle_kernel_rounds_states(_legacy_bundle(), _table(), ROUNDS)
    assert len(alive) == ROUNDS and max(alive) <= 1


def test_k3_spans_and_fold_visits_are_recorded():
    """A K3 bundle of M members over R round-slices: R ``pfola.round``, R·M
    ``pfola.project`` (one a member), R ``pfola.kernel`` named group_agg,
    and the fold visits of every member at its own shape."""
    b = _legacy_bundle()
    P, C = PARTS, _table()["_mask"].shape[1]
    with obs.recording():
        T.run_queries(T.QuerySpec(list(b.members), rounds=ROUNDS, emit="kernel"), _table(),
                      device="cpu")
    s = obs.summary()
    count = {k: v["count"] for k, v in s["spans"].items()}
    assert count["pfola.round"] == ROUNDS and count["pfola.kernel"] == ROUNDS
    assert count["pfola.project"] == ROUNDS * len(b.members)
    kernels = {r.attrs["kernel"] for r in obs.records() if r.name == "pfola.kernel"}
    members = sorted(r.attrs["member"] for r in obs.records() if r.name == "pfola.project")
    assert kernels == {"group_agg"} and members == sorted(list(range(3)) * ROUNDS)
    want = ops.group_step_visits(P, C // ROUNDS, CHUNK, [(1, 1), (4, 4), (1, 1000)]) * ROUNDS
    assert s["counters"]["pfola.fold.visits"] == want


def test_the_k1_wrappers_count_fold_visits_too():
    """The fused bundle (K1) counts its group members' visits, and its scalar
    member none."""
    fused = [T.make_sum_gla(TT.q6_func, TT.q6_cond(TT.Q6_LOW_WINDOW), d_total=float(ROWS)),
             T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small, num_groups=4,
                                d_total=float(ROWS), num_aggs=4)]
    with obs.recording():
        T.run_queries(T.QuerySpec(fused, rounds=ROUNDS, emit="kernel"), _table(),
                      device="cpu")
    C = _table()["_mask"].shape[1]
    assert obs.summary()["counters"]["pfola.fold.visits"] == ops.group_step_visits(
        PARTS, C, CHUNK, [(4, 4)])


def test_a_dropped_bundle_frees_its_members():
    """A bundle's memo keeps no bundle: the GLAs of a pass, and the dimension
    tables their closures hold (a join's per-query predicate table), go with
    the pass; the same members give the same bundle while it is alive."""
    import gc

    valid = torch.ones(1000, dtype=torch.bool)
    gla = T.make_join_groupby_gla(TT.q6_func, TT.q1_cond, lambda c: c["suppkey"],
                                  torch.zeros(1000, dtype=torch.int32), valid, num_groups=2,
                                  d_total=float(ROWS), device="cpu")
    b = T.GLABundle([gla])
    assert T.GLABundle((gla,)) is b
    T.run_queries(T.QuerySpec([gla], rounds=ROUNDS, emit="kernel"), _table(), device="cpu")
    table = weakref.ref(valid)
    del gla, b, valid
    gc.collect()
    assert table() is None
