"""Port parity for the kernels (``repro_torch.kernels``): K1 (scalar, group
and bundle, and its column decode), K2, K3 ``group_agg``, K4
``shard_chunk_partials``, K5 ``chunk_agg`` and K6 ``q6_agg``.

On the CPU the wrappers run their plain versions (``kernels/ref.py``); these
are held against the reference's Pallas kernels in interpret mode
(``repro.kernels.fused_agg`` and ``repro.kernels.ops``) on the same inputs
and the same carry.  The
CUDA kernels are held against the plain versions by the ``gpu`` tests,
which skip without a card (``chip_smoke.py`` runs the same checks at the
main path's shapes); they live in test_torch_kernels_gpu.py, which imports
no JAX so that it runs on a machine with a card.

Tolerances: counters (``scanned``, ``matched``) exact; f32 sums
rtol=1e-5 with atol=1e-5·max|ref| — the summation order differs.  A K1
bundle is held to the reference within tolerance, not bitwise (on jax 0.9.0
the reference's own fused and scan group states differ in low bits), and
to the port's solo plain versions bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gla as RG
from repro.core import randomize as RR
from repro.data import encodings as RE
from repro.data import tpch as RT
from repro.kernels import fused_agg as RFK
from repro.kernels import ops as ROPS
from repro_torch import convert
from repro_torch import gla as TG
from repro_torch.data import encodings as TE
from repro_torch.data import tpch as TT
from repro_torch.kernels import decode as TD
from repro_torch.kernels import fused_agg as FK
from repro_torch.kernels import ops, ref

P, C, L = 4, 8, 256
ROWS = P * C * L
RTOL = 1e-5


@pytest.fixture(scope="module")
def shards():
    raw = RT.generate_lineitem(ROWS, seed=21)
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in raw.items()},
                                jax.random.key(5), P)
    return {k: np.asarray(v)
            for k, v in RR.pack_partitions(parts, chunk_len=L).items()}


def _pair(name):
    d = float(ROWS)
    if name == "q6-low":
        return (RG.make_sum_gla(RT.q6_func, RT.q6_cond(RT.Q6_LOW_WINDOW), d_total=d),
                TG.make_sum_gla(TT.q6_func, TT.q6_cond(TT.Q6_LOW_WINDOW), d_total=d))
    if name == "q1-scalar":
        return (RG.make_sum_gla(RT.q1_func, RT.q1_cond, d_total=d, num_aggs=4),
                TG.make_sum_gla(TT.q1_func, TT.q1_cond, d_total=d, num_aggs=4))
    if name == "q1-small":
        return (RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_small,
                                    num_groups=4, d_total=d, num_aggs=4),
                TG.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small,
                                    num_groups=4, d_total=d, num_aggs=4))
    assert name == "q1-bucketed"
    kw = dict(num_groups=1000, bucket_bits=7, d_total=d, num_aggs=4)
    return (RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_large, **kw),
            TG.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_large, **kw))


def _assert_state(got, want):
    """Port SumState vs reference SumState (numpy leaves, same shapes)."""
    for f in ("scanned", "matched"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("sum", "sumsq"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(),
                                   err_msg=f)


def _ref_states(rgla, shards, lo, hi, carry_hi):
    """Reference interpret-mode K1: per partition, carry over [0, carry_hi)
    then one step over [lo, hi).  Returns (carries, advanced), stacked."""
    carries, outs = [], []
    for p in range(P):
        cols = {k: jnp.asarray(v[p]) for k, v in shards.items()}
        st = rgla.init()
        if carry_hi:
            st = RFK.fused_round_step(rgla, st, {k: v[:carry_hi] for k, v in cols.items()},
                                      interpret=True)
        carries.append(st)
        outs.append(RFK.fused_round_step(rgla, st, {k: v[lo:hi] for k, v in cols.items()},
                                         interpret=True))

    def stack(states):
        return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *states)

    return stack(carries), stack(outs)


@pytest.mark.parametrize("query", ["q6-low", "q1-scalar", "q1-small", "q1-bucketed"])
def test_round_step_matches_reference_interpret(shards, query):
    """K1 from the same mid-scan carry: the port starts from the reference's
    state (``convert.state_from_reference``) and both advance one round."""
    rgla, tgla = _pair(query)
    carry, want = _ref_states(rgla, shards, 4, 8, carry_hi=4)
    state = convert.state_from_reference(carry, device="cpu")
    cols = convert.shards_from_reference({k: v[:, 4:8] for k, v in shards.items()},
                                         device="cpu")
    before = FK.launch_counts()
    got = FK.fused_round_step(tgla, state, cols)
    assert FK.launch_counts() == before  # the CPU route launches nothing
    _assert_state(got, want)


def test_prefix_states_match_reference_interpret(shards):
    rgla, tgla = _pair("q6-low")
    finals, prefixes = [], []
    for p in range(P):
        f, pre = RFK.fused_prefix_states(
            rgla, {k: jnp.asarray(v[p]) for k, v in shards.items()}, interpret=True)
        finals.append(f)
        prefixes.append(pre)

    def stack(states):
        return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *states)

    f_t, pre_t = FK.fused_prefix_states(
        tgla, convert.shards_from_reference(shards, device="cpu"))
    _assert_state(f_t, stack(finals))
    _assert_state(pre_t, stack(prefixes))
    assert pre_t.sum.shape == (P, C + 1, 1)


def _random_inputs(seed, A=3, G=37, Cn=5, Ln=100):
    g = torch.Generator().manual_seed(seed)
    vals = torch.rand((P, Cn, Ln, A), generator=g) * 100
    w = (torch.rand((P, Cn, Ln), generator=g) < 0.4).float()
    gids = torch.randint(-2, G + 2, (P, Cn, Ln), generator=g, dtype=torch.int32)
    carry = torch.cat([torch.rand((P, 2 * A), generator=g),
                       torch.randint(0, 9, (P, 1), generator=g).float()], 1)
    cs, cq = torch.rand((P, G, A), generator=g), torch.rand((P, G, A), generator=g)
    cm = torch.randint(0, 9, (P, G), generator=g).float()
    return vals, w, gids, carry, cs, cq, cm


def test_plain_prefix_is_the_round_step_fold():
    """K2's last running value is K1's fold from a zero carry, bit for bit;
    out-of-range group ids drop out, as in segment_sum."""
    vals, w, gids, carry, cs, cq, cm = _random_inputs(0)
    pre = ref.scalar_prefix(vals, w)
    zero = torch.zeros_like(carry)
    assert torch.equal(pre[:, -1], ref.scalar_round_step(vals, w, zero))
    s, q, m = ref.group_round_step(vals, w, gids, cs, cq, cm)
    G = cs.shape[1]
    keep = ((gids >= 0) & (gids < G)).float()
    assert torch.equal(m.sum(1) - cm.sum(1), (w * keep).sum((1, 2)))


def test_group_step_adds_each_chunk_total_to_the_carry():
    """Each chunk's per-group sums are formed from zero and added to the
    carry once, as the reference adds its segment sums to the state: rows
    added one by one onto a carry of 2**24 would each round away."""
    Pn, Cn, Ln, G = 2, 3, 64, 2
    big = float(2 ** 24)
    vals, w = torch.ones((Pn, Cn, Ln, 1)), torch.ones((Pn, Cn, Ln))
    gids = torch.zeros((Pn, Cn, Ln), dtype=torch.int32)
    cs, cq = torch.full((Pn, G, 1), big), torch.full((Pn, G, 1), big)
    s, q, m = FK.group_round_step(vals, w, gids, cs, cq, torch.full((Pn, G), big))
    want = torch.tensor([big + Cn * Ln, big]).expand(Pn, G)
    for x in (s[..., 0], q[..., 0], m):
        assert torch.equal(x, want)


def test_wrappers_check_their_inputs():
    vals, w, gids, carry, cs, cq, cm = _random_inputs(1)
    with pytest.raises(ValueError, match="dtype"):
        FK.scalar_round_step(vals.double(), w, carry)
    with pytest.raises(ValueError, match="shape"):
        FK.scalar_round_step(vals, w[:, :1], carry)
    with pytest.raises(ValueError, match="contiguous"):
        FK.scalar_prefix(vals, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="dtype"):
        FK.group_round_step(vals, w, gids.long(), cs, cq, cm)
    with pytest.raises(ValueError, match="no kernel for device"):
        FK.scalar_prefix(vals.to("meta"), w.to("meta"))


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max())


@pytest.mark.parametrize("A,G", [(1, 5), (4, 10), (3, 37)])
def test_group_agg_matches_reference_interpret(A, G):
    """K3 with block_rows = L against the reference's one-hot Pallas kernel,
    one partition at a time; ids outside [0, G) drop out in both."""
    vals, w, gids, *_ = _random_inputs(3, A=A, G=G, Cn=4, Ln=128)
    Pn, Cn, Ln, _ = vals.shape
    flat = (vals.reshape(Pn, -1, A), w.reshape(Pn, -1), gids.reshape(Pn, -1))
    got = ops.group_agg(*flat, num_groups=G, block_rows=Ln)
    for p in range(Pn):
        want = ROPS.group_agg(jnp.asarray(flat[0][p].numpy()),
                              jnp.asarray(flat[1][p].numpy()),
                              jnp.asarray(flat[2][p].numpy()), num_groups=G,
                              block_rows=Ln, interpret=True)
        _close(got[0][p], want[0])
        _close(got[1][p], want[1])
        np.testing.assert_array_equal(got[2][p].numpy(), np.asarray(want[2]))


def test_group_agg_is_the_group_step_from_zero():
    """K3 over C·L rows equals K1 group from a zero carry with L-row chunks,
    bit for bit; [P, N] vals are one aggregate."""
    vals, w, gids, *_ = _random_inputs(4, A=2, G=9, Cn=3, Ln=64)
    Pn, Cn, Ln, A = vals.shape
    z = torch.zeros((Pn, 9, A))
    want = ref.group_round_step(vals, w, gids, z, z, z[..., 0])
    got = ops.group_agg(vals.reshape(Pn, -1, A), w.reshape(Pn, -1),
                        gids.reshape(Pn, -1), num_groups=9, block_rows=Ln)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    one = ops.group_agg(vals[..., 0].reshape(Pn, -1).contiguous(), w.reshape(Pn, -1),
                        gids.reshape(Pn, -1), num_groups=9, block_rows=Ln)
    assert torch.equal(one[0][..., 0], got[0][..., 0])


@pytest.mark.parametrize("P, C, L, members", [
    (8, 896, 2048, [(4, 4)]),  # Q1-small round-slice: one tile
    (8, 896, 2048, [(4, 8192)]),  # Q1-large: tables past the input bytes
    (8, 2688, 2048, [(4, 10)]),  # the [Q6, Q1-small, Q3] K3 stack
    (8, 896, 2048, [(4, 4), (4, 8192), (4, 25)]),  # a K1 bundle's group members
    (3, 23, 2048, [(4, 8192)]),  # tiles of 13 chunks, the last one ragged
    (2, 5, 1000, [(2, 5000)]),  # G > L
    (4, 0, 2048, [(1, 5)]),  # no chunks
], ids=["q1-small", "q1-large", "k3-stack", "bundle", "ragged-tiles", "g-past-l",
        "no-chunks"])
def test_group_step_scratch_stays_within_the_input_bytes(P, C, L, members):
    """The group step's scratch (one compacted table per chunk and member)
    takes as many chunks per tile as keep it within the members' own input
    bytes, and no more; a chunk's table holds W + 1 offsets and min(L, G)
    ids and (2A+1)-sum entries."""
    assert ops.group_step_words(2048, 4, 4) == 1 + 1 + 4 * 10
    assert ops.group_step_words(2048, 4, 8192) == 256 + 1 + 2048 * 10
    tile = ops.group_step_tile(C, L, members)
    assert 1 <= tile <= max(C, 1)
    inp = P * C * sum(L * (4 * A + 8) for A, _ in members)
    per_chunk = 4 * P * sum(ops.group_step_words(L, A, G) for A, G in members)
    if tile > 1:
        assert per_chunk * min(tile, C) <= inp
    if tile < C:
        assert per_chunk * (tile + 1) > inp
    A, G = members[0]
    got = ops.group_step_scratch(P, C, L, A, G, tile, torch.device("cpu"))
    assert got.dtype == torch.float32
    assert got.numel() == P * min(tile, C) * ops.group_step_words(L, A, G)
    if (P, C) == (3, 23):
        assert (tile, C % tile) == (13, 10)


@pytest.mark.parametrize("L, A, G, span, words", [
    (2048, 1, 1_000_000, 32, 977 + 1 + 2048 * 4),  # Q15 at SF 100: windows of 1,024 ids
    (2048, 1, 100_000, 8, 391 + 1 + 2048 * 4),  # Q15 at SF 10: windows of 256 ids
    (2048, 4, 4, 1, 1 + 1 + 4 * 10),  # Q1's returnflag x linestatus
    (2048, 4, 8192, 1, 256 + 1 + 2048 * 10),  # 2^13 buckets: 7 a window already
    (2048, 4, 10, 1, 1 + 1 + 10 * 10),  # the [Q6, Q1-small, Q3] K3 stack
    (2048, 1, 5, 1, 1 + 1 + 5 * 4),  # Q3 by segment (K3)
    (2048, 4, 16384, 2, 256 + 1 + 2048 * 10),  # G = 8L: the first shape past 1
    (2048, 8, 1_000_000, 4, 7813 + 1 + 2048 * 18),  # 17 columns: the cap binds
    (2048, 48, 1_000_000, 1, 31250 + 1 + 2048 * 98),  # 97 columns: one id a lane
    (1000, 2, 50_000, 8, 196 + 1 + 1000 * 6),  # L not a power of two
], ids=["q15-sf100", "q15-sf10", "q1-small", "q1-large", "k3-stack", "k3-q3",
        "g-8l", "capped", "too-wide", "odd-rows"])
def test_group_step_span_follows_the_members_shape(L, A, G, span, words):
    """The fold's ids a lane (``group_step_span``) read from L, A and G
    alone, and the chunk table's size that follows from it."""
    assert ops.group_step_span(L, A, G) == span
    assert ops.group_step_words(L, A, G) == words
    assert 32 * span * (2 * A + 1) <= ops.FOLD_SPAN_FLOATS or span == 1


def test_group_step_span_is_the_largest_power_of_two_that_fits():
    """s is a power of two, 1 while G < 8L; doubling it would pass G / 4L
    or the shared-memory budget of a warp's carry."""
    rng = np.random.default_rng(5)
    for _ in range(2000):
        L = int(rng.integers(1, 4097))
        A = int(rng.integers(1, 64))
        G = int(rng.integers(1, 3_000_000))
        s = ops.group_step_span(L, A, G)
        assert s >= 1 and s & (s - 1) == 0
        if G < 8 * L:
            assert s == 1
        if s > 1:
            assert 4 * s * L <= G and 32 * s * (2 * A + 1) <= ops.FOLD_SPAN_FLOATS
        assert 8 * s * L > G or 64 * s * (2 * A + 1) > ops.FOLD_SPAN_FLOATS


@pytest.mark.parametrize("C, members, tile", [
    (2289, [(4, 4), (1, 1_000_000)], 2289),  # the report bundle at SF 100
    (228, [(4, 4), (1, 100_000)], 228),  # and at SF 10
    (2289, [(1, 1_000_000)], 1533),  # Q15 alone: 36,680 B a table, 24,576 of input
    (896, [(4, 8192)], 530),  # 2^13 buckets: two tiles, as before
], ids=["report-sf100", "report-sf10", "q15-solo", "q1-large"])
def test_group_step_tile_at_the_cells_shapes(C, members, tile):
    """At both report cells' shapes a round-slice's group step takes one
    tile (Q1's input bytes beside Q15's hold both members' tables); alone,
    Q15's and the bucket table's tables pass their input bytes."""
    assert ops.group_step_tile(C, 2048, members) == tile


def _wide_folds(members, L=2048) -> int:
    """``pfola.fold.wide`` as one launch of ``members`` ((A, G) each) adds it."""
    from repro_torch import obs

    before = obs.summary()["counters"].get("pfola.fold.wide", 0)
    with obs.recording():
        ops.count_wide_folds(members, L)
    return obs.summary()["counters"].get("pfola.fold.wide", 0) - before


@pytest.mark.parametrize("A, G, drops", [
    (1, 1_000_000, True),  # Q15 by supplier at SF 100
    (1, 100_000, True),  # Q15 at SF 10
    (1, 15_000_000, True),  # Q10 by customer (sf100-report-join)
    (4, 4, False),  # Q1 by returnflag x linestatus
    (1, 1, False),  # Q6, a one-group member of a K3 bundle
    (1, 2, False),  # Q14 by promotion or not
    (1, 5, False),  # Q3 by segment (K3)
    (4, 8192, False),  # Q1 in 2^13 buckets
], ids=["q15-sf100", "q15-sf10", "q10", "q1", "q6", "q14", "q3", "buckets"])
def test_phase_one_drops_zero_weight_rows_exactly_where_the_fold_is_wide(A, G, drops):
    """Phase 1 drops the rows that cannot change a sum before its sort for
    the members whose fold is wide (s > 1, ``group_step_span``), and only
    for them: the cells' Q15 and Q10, not Q1, Q6, Q14, Q3 or the buckets,
    whose runs hold many rows.  ``pfola.fold.wide`` counts those members."""
    assert (ops.group_step_span(2048, A, G) > 1) == drops
    assert _wide_folds([(A, G)]) == int(drops)


@pytest.mark.parametrize("members, wide", [
    ([(4, 4), (1, 1_000_000)], 1),
    ([(4, 4), (1, 100_000)], 1),
    ([(1, 1), (4, 4), (1, 1_000_000), (1, 15_000_000), (1, 2)], 2),
], ids=["report-sf100", "report-sf10", "report-join"])
def test_wide_fold_counter_counts_the_bundles_dropping_members(members, wide):
    """A report bundle's group members (Q1, Q15) count 1 a launch at both
    scales, the join cell's K3 bundle (Q6, Q1, Q15, Q10, Q14) 2: the
    members whose phase 1 drops rows."""
    assert _wide_folds(members) == wide


def test_rank_sort_rows_mirrors_the_kernel_constant():
    """``ops.RANK_SORT_ROWS`` is ``kRankSortRows`` of the kernel, at most one
    kept row a thread of phase 1's block (``kStepThreads``)."""
    import re
    from pathlib import Path

    src = (Path(ops.__file__).parent / "csrc" / "agg_common.cuh").read_text()
    rows = re.search(r"constexpr int kRankSortRows = (\d+);", src)
    threads = re.search(r"constexpr int kStepThreads = (\d+);", src)
    assert int(rows.group(1)) == ops.RANK_SORT_ROWS
    assert 0 < ops.RANK_SORT_ROWS <= int(threads.group(1))


def test_plain_route_counts_no_wide_fold():
    """``pfola.fold.wide`` counts members launched on the card: the plain
    route of a member with s > 1 launches none and counts nothing."""
    from repro_torch import obs

    Pn, Cn, Ln, G = 2, 2, 64, 1000
    g = torch.Generator().manual_seed(3)
    vals = torch.rand((Pn, Cn, Ln, 1), generator=g)
    w = torch.ones((Pn, Cn, Ln))
    gids = torch.randint(0, G, (Pn, Cn, Ln), generator=g, dtype=torch.int32)
    carry = (torch.zeros((Pn, G, 1)), torch.zeros((Pn, G, 1)), torch.zeros((Pn, G)))
    assert ops.group_step_span(Ln, 1, G) > 1
    before = obs.summary()["counters"].get("pfola.fold.wide", 0)
    with obs.recording():
        FK.group_round_step(vals, w, gids, *carry)
        ops.group_agg(vals.reshape(Pn, -1, 1), w.reshape(Pn, -1), gids.reshape(Pn, -1),
                      num_groups=G, block_rows=Ln)
    assert obs.summary()["counters"].get("pfola.fold.wide", 0) == before


def test_shard_chunk_partials_matches_reference_interpret(shards):
    """K4 on the Q6 projection of every partition (weight = the bare
    predicate, the mask separate) against the reference's Pallas kernel."""
    _, tgla = _pair("q6-low")
    cols = convert.shards_from_reference(shards, device="cpu")
    vals, weight = tgla.kernel_cols(cols)
    got = ops.shard_chunk_partials(vals, weight, cols["_mask"])
    assert got.shape == (P, C, 4)
    for p in range(P):
        want = ROPS.shard_chunk_partials(
            jnp.asarray(vals[p].numpy()), jnp.asarray(weight[p].numpy()),
            jnp.asarray(shards["_mask"][p]), interpret=True)
        _close(got[p, :, :2], want[:, :2])
        np.testing.assert_array_equal(got[p, :, 2:].numpy(), np.asarray(want[:, 2:]))


def test_shard_chunk_partials_casts_its_inputs():
    """Like the reference wrapper, any numeric dtype is cast to f32."""
    vals = torch.arange(2 * 3 * 8, dtype=torch.int32).reshape(2, 3, 8)
    pred = (vals % 3 == 0)
    mask = torch.ones((2, 3, 8), dtype=torch.float64)
    got = ops.shard_chunk_partials(vals, pred, mask)
    want = ref.shard_chunk_partials(vals.float(), pred.float(), mask.float())
    assert got.dtype == torch.float32 and torch.equal(got, want)


def _bundle_pair():
    names = ["q6-low", "q1-small", "q1-bucketed", "q1-scalar"]
    pairs = [_pair(n) for n in names]
    return (RG.GLABundle([r for r, _ in pairs]),
            TG.GLABundle([t for _, t in pairs]), [t for _, t in pairs])


def test_bundle_round_step_matches_reference_interpret(shards):
    """K1 bundle from the same mid-scan carries: within tolerance of the
    reference's one-pallas_call bundle, bitwise-equal to each member's
    solo plain step."""
    rb, tb, solos = _bundle_pair()
    carry, want = _ref_states(rb, shards, 4, 8, carry_hi=4)
    state = tuple(convert.state_from_reference(c, device="cpu") for c in carry)
    cols = convert.shards_from_reference({k: v[:, 4:8] for k, v in shards.items()},
                                         device="cpu")
    got = FK.fused_round_step(tb, state, cols)
    assert isinstance(got, tuple) and len(got) == len(solos)
    for g, w, st, solo in zip(got, want, state, solos):
        _assert_state(g, w)
        alone = FK.fused_round_step(solo, st, cols)
        assert all(torch.equal(a, b) for a, b in zip(g, alone))


def test_probe_tables_enter_the_column_dict():
    """A join's fused closures read their probe tables by key: project()
    puts them into the columns before the closures run, and a table shared
    by two members counts once against the budget."""
    n = 50
    keys = torch.arange(2 * 1 * n, dtype=torch.int32).reshape(2, 1, n) % 7
    cols = {"k": keys, "v": torch.ones((2, 1, n)), "_mask": torch.ones((2, 1, n))}
    jg = TG.make_join_groupby_gla(
        lambda c: c["v"], lambda c: torch.ones_like(c["v"]), lambda c: c["k"],
        torch.tensor([0, 1, 2, 0, 1, 2, 0]), torch.tensor([1., 1, 1, 1, 0, 0, 1]),
        num_groups=3, d_total=100.0, device="cpu")
    specs = FK.fused_members(TG.GLABundle([jg, jg]))
    assert len(FK.unique_probes(specs)) == 2
    assert FK.probe_bytes(jg) == 7 * 4 * 2
    assert FK.probe_bytes(TG.GLABundle([jg, jg])) == FK.probe_bytes(jg)
    vals, w, gids = FK.project(jg.fused, cols)
    v2, w2, g2 = jg.kernel_cols(cols)
    assert set(cols) == {"k", "v", "_mask"}  # the caller's dict is untouched
    assert torch.equal(gids, g2.to(torch.int32)) and torch.equal(w, (w2 * cols["_mask"]))


def test_new_wrappers_check_their_inputs():
    vals, w, gids, carry, cs, cq, cm = _random_inputs(5)
    Pn, Cn, Ln, A = vals.shape
    flat = (vals.reshape(Pn, -1, A), w.reshape(Pn, -1), gids.reshape(Pn, -1))
    with pytest.raises(ValueError, match="block_rows"):
        ops.group_agg(*flat, num_groups=4, block_rows=Ln + 1)
    with pytest.raises(ValueError, match="dtype"):
        ops.group_agg(flat[0], flat[1], flat[2].long(), num_groups=4, block_rows=Ln)
    with pytest.raises(ValueError, match="shape"):
        ops.group_agg(flat[0], flat[1][:, 1:], flat[2], num_groups=4, block_rows=Ln)
    with pytest.raises(ValueError, match="contiguous"):
        ops.group_agg(flat[0].transpose(0, 1).contiguous().transpose(0, 1),
                      flat[1], flat[2], num_groups=4, block_rows=Ln)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.group_agg(*(t.to("meta") for t in flat), num_groups=4, block_rows=Ln)
    with pytest.raises(ValueError, match="shape"):
        ops.shard_chunk_partials(vals[..., 0], w, w[:, :1])
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.shard_chunk_partials(*(t.to("meta") for t in (vals[..., 0], w, w)))
    with pytest.raises(ValueError, match="members"):
        FK.bundle_round_step([])
    with pytest.raises(ValueError, match="shape"):
        FK.bundle_round_step([(vals, w, None, carry),
                              (vals[:, :2].contiguous(), w[:, :2].contiguous(),
                               None, carry)])
    with pytest.raises(ValueError, match="same P, C, L"):
        FK.bundle_round_step([(vals, w, None, carry),
                              (vals[:, :2].contiguous(), w[:, :2].contiguous(),
                               gids[:, :2].contiguous(), cs, cq, cm)])
    with pytest.raises(ValueError, match="shape"):
        FK.bundle_round_step([(vals, w, gids, cs, cq, cm[:, :2].contiguous())])


def _q6_columns(n, seed):
    """Flat Q6 columns as the reference's ``test_q6_fused_kernel`` draws
    them, shipdate int32 as stored."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2526, n).astype(np.int32),
            (rng.integers(0, 11, n) / 100.0).astype(np.float32),
            rng.integers(1, 51, n).astype(np.float32),
            rng.uniform(1, 100, n).astype(np.float32),
            rng.integers(0, 2, n).astype(np.float32))


def _assert_sums(got, want):
    """[4] (sum, sumsq, scanned, matched): counters exact, sums within RTOL."""
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got[2:], want[2:])
    np.testing.assert_allclose(got[:2], want[:2], rtol=RTOL)


@pytest.mark.parametrize("n", [128, 640, 5000])
def test_chunk_agg_matches_reference_interpret(n):
    rng = np.random.default_rng(n)
    vals = rng.normal(size=n).astype(np.float32)
    w = rng.integers(0, 2, n).astype(np.float32)
    m = rng.integers(0, 2, n).astype(np.float32)
    got = ops.chunk_agg(*(torch.from_numpy(x) for x in (vals, w, m)))
    want = ROPS.chunk_agg(jnp.asarray(vals), jnp.asarray(w), jnp.asarray(m),
                          interpret=True)
    assert got.shape == (4,) and got.dtype == torch.float32
    _assert_sums(got, want)


def test_chunk_agg_casts_its_inputs():
    vals = torch.arange(50, dtype=torch.int32)
    got = ops.chunk_agg(vals, vals % 3 == 0, torch.ones(50, dtype=torch.float64))
    want = ref.chunk_agg(vals.float(), (vals % 3 == 0).float(), torch.ones(50))
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("n", [256, 2048, 3333])
def test_q6_agg_matches_reference_interpret(n):
    cols = _q6_columns(n, n)
    cols[2][::3] = 1.0  # quantity == 1 often enough for rows to match
    params = np.array([420, 785, 0.02, 0.03, 1.0], np.float32)
    got = ops.q6_agg(torch.from_numpy(params), *(torch.from_numpy(c) for c in cols))
    want = ROPS.q6_agg(jnp.asarray(params), *(jnp.asarray(c) for c in cols),
                       interpret=True)
    _assert_sums(got, want)
    assert n < 1000 or got[3] > 0  # the predicate selects rows


def test_q6_agg_is_the_q6_closures():
    """K6 with the Q6 window's params is the port's q6_func/q6_cond."""
    sd, dc, qt, ep, m = (torch.from_numpy(c) for c in _q6_columns(4000, 1))
    qt[::7] = 1.0
    lo, hi = TT.Q6_LOW_WINDOW
    params = torch.tensor([lo, hi, 0.02 - 1e-6, 0.03 + 1e-6, 1.0])
    chunk = {"shipdate": sd, "discount": dc, "quantity": qt, "extendedprice": ep}
    cond = TT.q6_cond(TT.Q6_LOW_WINDOW)(chunk)
    want = ref.chunk_agg(TT.q6_func(chunk), cond, m)
    assert torch.equal(ops.q6_agg(params, sd, dc, qt, ep, m), want)
    assert want[3] > 0


def test_chunk_and_q6_agg_check_their_inputs():
    sd, dc, qt, ep, m = (torch.from_numpy(c) for c in _q6_columns(64, 2))
    params = torch.tensor([420.0, 785.0, 0.02, 0.03, 1.0])
    with pytest.raises(ValueError, match="flat"):
        ops.chunk_agg(ep.reshape(8, 8), m.reshape(8, 8), m.reshape(8, 8))
    with pytest.raises(ValueError, match="shape"):
        ops.chunk_agg(ep, m[:32], m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.chunk_agg(*(t.to("meta") for t in (ep, m, m)))
    with pytest.raises(ValueError, match="dtype"):
        ops.q6_agg(params, sd.float(), dc, qt, ep, m)
    with pytest.raises(ValueError, match="dtype"):
        ops.q6_agg(params, sd, dc.double(), qt, ep, m)
    with pytest.raises(ValueError, match="params"):
        ops.q6_agg(params[:4], sd, dc, qt, ep, m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.q6_agg(*(t.to("meta") for t in (params, sd, dc, qt, ep, m)))


@pytest.mark.parametrize("enc", [
    TE.DictEncoding((0.0, 0.01, 0.02, 0.05), code_dtype="int8"),
    TE.DictEncoding(tuple(float(v) for v in range(-200, 300)), code_dtype="int16"),
    TE.BitPackedEncoding(1), TE.BitPackedEncoding(2), TE.BitPackedEncoding(12),
    TE.BitPackedEncoding(16)], ids=["dict-int8", "dict-int16", "bits-1", "bits-2",
                                     "bits-12", "bits-16"])
def test_decode_plain_version_matches_reference(enc):
    """The plain decode (``ref.decode_dict``/``decode_bitpacked``, what
    ``pf_decode`` is held to) against ``repro.data.encodings.decode_cols``."""
    rng = np.random.default_rng(len(str(enc)))
    shape = (P, 3, 96)
    if isinstance(enc, TE.DictEncoding):
        a = rng.choice(np.asarray(enc.values, np.float32), shape)
        r = RE.DictEncoding(*enc)
    else:
        a = rng.integers(0, 1 << enc.bits, shape, dtype=np.int32)
        r = RE.BitPackedEncoding(*enc)
    phys = TE.encode_array(a, enc)
    got = TD.decode([(torch.from_numpy(phys), enc)])[0]
    want = RE.decode_cols({"c": jnp.asarray(phys)}, (("c", r),))["c"]
    assert got.numpy().tobytes() == np.asarray(want).tobytes() == a.tobytes()
    assert FK.LAUNCHES["decode"] == 0  # the plain route launches nothing
