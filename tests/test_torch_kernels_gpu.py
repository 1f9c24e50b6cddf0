"""The port's CUDA kernels against their plain PyTorch versions, on a card:
K1 (scalar, group, bundle, and its column decode ``pf_decode``), K2, K3,
K4, K5 ``chunk_agg`` and K6 ``q6_agg``, K1 from carries merged or split
for another partition count, a small streamed session, a streamed
partition loss, an elastic resume, two gloo ranks sharing the card
(``repro_torch.sharded``), and serving banks (``repro_torch.service``: a
32-slot bank in two bundle launches, a late joiner bitwise its solo
session), the sketch GLAs' states (``repro_torch.sketch``) on the card
bitwise the CPU port's, and ``randomize.randomize_distributed`` on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The file
imports no JAX, so it runs on a machine that has a card but not the JAX
package's dependencies:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: counters (``scanned``, ``matched``) exact; f32 sums rtol=1e-5
with atol=1e-5·max|plain| — the kernels sum in another order; repeat runs
bitwise-equal (no atomics).  The decode is exact: bitwise.
"""
import numpy as np
import pytest
import torch

import repro_torch as T
from repro_torch import randomize, scan
from repro_torch.data import encodings as ENC
from repro_torch.data import source as DS
from repro_torch.data import tpch
from repro_torch.kernels import decode as KD
from repro_torch.kernels import fused_agg as FK
from repro_torch.kernels import ops, ref
from repro_torch.uda import tree_map

RTOL = 1e-5


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _close(a, b):
    torch.testing.assert_close(a, b, rtol=RTOL, atol=RTOL * b.abs().max().item())


def _random_inputs(seed, dev, P=4, A=3, G=37, C=5, L=100):
    g = torch.Generator().manual_seed(seed)
    vals = torch.rand((P, C, L, A), generator=g) * 100
    w = (torch.rand((P, C, L), generator=g) < 0.4).float()
    gids = torch.randint(-2, G + 2, (P, C, L), generator=g, dtype=torch.int32)
    carry = torch.cat([torch.rand((P, 2 * A), generator=g),
                       torch.randint(0, 9, (P, 1), generator=g).float()], 1)
    cs, cq = torch.rand((P, G, A), generator=g), torch.rand((P, G, A), generator=g)
    cm = torch.randint(0, 9, (P, G), generator=g).float()
    return [t.to(dev) for t in (vals, w, gids, carry, cs, cq, cm)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    dict(A=3, G=37, C=5, L=100),  # ragged: L not a power of two
    dict(A=1, G=4, C=64, L=2048),  # Q6 / Q1-small widths
    dict(A=4, G=8192, C=16, L=2048),  # Q1 with 2^13 buckets
    dict(A=2, G=7, C=3, L=1001),  # L odd: the scalar kernels' 4-byte loads
], ids=["ragged", "small-groups", "buckets", "odd-rows"])
def test_kernels_match_plain_versions(shape):
    dev = _cuda()
    vals, w, gids, carry, cs, cq, cm = _random_inputs(0, dev, **shape)
    A = vals.shape[-1]
    before = FK.launch_counts()
    k1 = FK.scalar_round_step(vals, w, carry)
    r1 = ref.scalar_round_step(vals, w, carry)
    _close(k1[:, :2 * A], r1[:, :2 * A])
    assert torch.equal(k1[:, 2 * A], r1[:, 2 * A])
    k2 = FK.scalar_prefix(vals, w)
    r2 = ref.scalar_prefix(vals, w)
    _close(k2[..., :2 * A], r2[..., :2 * A])
    assert torch.equal(k2[..., 2 * A], r2[..., 2 * A])
    kg = FK.group_round_step(vals, w, gids, cs, cq, cm)
    rs, rq, rm = ref.group_round_step(vals, w, gids, cs, cq, cm)
    _close(kg[0], rs)
    _close(kg[1], rq)
    assert torch.equal(kg[2], rm)
    again = (FK.scalar_round_step(vals, w, carry), FK.scalar_prefix(vals, w),
             *FK.group_round_step(vals, w, gids, cs, cq, cm))
    assert all(torch.equal(a, b) for a, b in zip((k1, k2, *kg), again))
    after = FK.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "fused_round_step/scalar": 2, "fused_round_step/group": 2,
        "fused_prefix_states": 2}


@pytest.mark.gpu
def test_group_kernel_adds_each_chunk_total_to_the_carry():
    """As the plain version: a run's rows are summed from zero and the
    total added to the carry once per chunk; rows added one by one onto a
    carry of 2**24 would each round away."""
    dev = _cuda()
    P, C, L, G = 2, 3, 64, 2
    big = float(2 ** 24)
    vals = torch.ones((P, C, L, 1), device=dev)
    w = torch.ones((P, C, L), device=dev)
    gids = torch.zeros((P, C, L), dtype=torch.int32, device=dev)
    cs, cq = (torch.full((P, G, 1), big, device=dev) for _ in range(2))
    cm = torch.full((P, G), big, device=dev)
    s, q, m = FK.group_round_step(vals, w, gids, cs, cq, cm)
    want = torch.tensor([big + C * L, big], device=dev).expand(P, G)
    for x in (s[..., 0], q[..., 0], m):
        assert torch.equal(x, want)


def _edge_inputs(case, dev):
    """Inputs for the cases the chunk-parallel group step makes risky; the
    ``span-*`` cases take windows of 32·s ids (G > L, s > 1)."""
    shape = {"one-group": dict(A=2, G=1, C=6, L=2048),
             "distinct-ids": dict(A=2, G=5000, C=4, L=1000),
             "out-of-range": dict(A=3, G=37, C=5, L=512),
             "rows-1000": dict(A=4, G=4, C=7, L=1000),
             "rows-max": dict(A=4, G=8192, C=3, L=4096),
             "tiled": dict(A=4, G=8192, C=23, L=2048),
             "span-ragged": dict(A=1, G=100_003, C=7, L=2048),
             "span-out-of-range": dict(A=2, G=50_000, C=5, L=2048),
             "span-clustered": dict(A=1, G=1_000_000, C=5, L=2048),
             "span-repeats": dict(A=1, G=1_000_000, C=9, L=2048)}[case]
    vals, w, gids, _, cs, cq, cm = _random_inputs(30, dev, P=3, **shape)
    P, C, L, A = vals.shape
    G = shape["G"]
    g = torch.Generator().manual_seed(31)
    if case == "one-group":  # one run of L rows per chunk, across every warp
        gids = torch.zeros_like(gids)
    elif case == "distinct-ids":  # every id of a chunk distinct, G > L
        gids = torch.stack([torch.randperm(G, generator=g)[:L] for _ in range(P * C)])
        gids = gids.reshape(P, C, L).to(torch.int32).to(dev)
    elif case in ("out-of-range", "span-out-of-range"):  # a third below 0 or >= G
        gids = torch.randint(-G, 2 * G, (P, C, L), generator=g, dtype=torch.int32).to(dev)
    elif case == "span-ragged":  # G not a multiple of 32·s: the last window short
        gids = torch.randint(0, G, (P, C, L), generator=g, dtype=torch.int32).to(dev)
    elif case == "span-clustered":  # a chunk's ids within 4,096: hundreds a window
        base = torch.randint(0, G - 4096, (P, C, 1), generator=g)
        gids = (base + torch.randint(0, 4096, (P, C, L), generator=g)).to(torch.int32).to(dev)
    elif case == "span-repeats":  # ids 0-47 in every chunk, beside uniform ones
        few = torch.randint(0, 48, (P, C, L), generator=g)
        gids = torch.where(torch.rand((P, C, L), generator=g) < 0.5, few,
                           torch.randint(0, G, (P, C, L), generator=g))
        gids = gids.to(torch.int32).to(dev)
    return vals, w, gids, cs, cq, cm


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one-group", "distinct-ids", "out-of-range",
                                  "rows-1000", "rows-max", "tiled", "span-ragged",
                                  "span-out-of-range", "span-clustered",
                                  "span-repeats"])
def test_group_step_edge_cases_match_plain_versions(case):
    """K1 group and K3 against their plain versions (counters exact, sums
    within RTOL), repeats bitwise-equal, one launch per call."""
    dev = _cuda()
    vals, w, gids, cs, cq, cm = _edge_inputs(case, dev)
    P, C, L, A = vals.shape
    G = cm.shape[-1]
    assert (ops.group_step_span(L, A, G) > 1) == case.startswith("span")
    if case in ("tiled", "span-ragged"):  # the scratch takes tiles, the last one ragged
        tile = ops.group_step_tile(C, L, [(A, G)])
        assert tile < C and C % tile
    before = FK.launch_counts()
    got = FK.group_round_step(vals, w, gids, cs, cq, cm)
    again = FK.group_round_step(vals, w, gids, cs, cq, cm)
    want = ref.group_round_step(vals, w, gids, cs, cq, cm)
    flat = (vals.reshape(P, C * L, A), w.reshape(P, -1), gids.reshape(P, -1))
    got3 = ops.group_agg(*flat, num_groups=G, block_rows=L)
    again3 = ops.group_agg(*flat, num_groups=G, block_rows=L)
    want3 = ref.group_agg(*flat, G, L)
    assert _delta(before) == {"fused_round_step/group": 2, "group_agg": 2}
    for g_, a_, r_ in ((got, again, want), (got3, again3, want3)):
        assert all(torch.equal(x, y) for x, y in zip(g_, a_))
        _close(g_[0], r_[0])
        _close(g_[1], r_[1])
        assert torch.equal(g_[2], r_[2])


def _q15_inputs(dev, G, P=2, C=12, L=2048, seed=60):
    """A round-slice shaped as Q15's: one value, uniform supplier ids, w
    zero on about 96% of the rows (outside the quarter), random carries."""
    g = torch.Generator().manual_seed(seed)
    vals = torch.rand((P, C, L, 1), generator=g) * 1e4
    w = (torch.rand((P, C, L), generator=g) < 0.04).float()
    gids = torch.randint(0, G, (P, C, L), generator=g, dtype=torch.int32)
    cs = torch.rand((P, G, 1), generator=g) * 1e6
    cq = torch.rand((P, G, 1), generator=g) * 1e9
    cm = torch.randint(0, 500, (P, G), generator=g).float()
    return [t.to(dev) for t in (vals, w, gids, cs, cq, cm)]


@pytest.mark.gpu
@pytest.mark.parametrize("G", [100_000, 1_000_000], ids=["sf10", "sf100"])
def test_group_step_at_q15_shapes_matches_plain_versions(G):
    """K1 group and K3 at Q15's widths (L = 2048, A = 1; s = 8 and 32)
    against their plain versions: counters exact, sums within RTOL."""
    dev = _cuda()
    vals, w, gids, cs, cq, cm = _q15_inputs(dev, G)
    P, C, L, A = vals.shape
    assert ops.group_step_span(L, A, G) == {100_000: 8, 1_000_000: 32}[G]
    got = FK.group_round_step(vals, w, gids, cs, cq, cm)
    want = ref.group_round_step(vals, w, gids, cs, cq, cm)
    flat = (vals.reshape(P, C * L, A), w.reshape(P, -1), gids.reshape(P, -1))
    got3 = ops.group_agg(*flat, num_groups=G, block_rows=L)
    want3 = ref.group_agg(*flat, G, L)
    for g_, r_ in ((got, want), (got3, want3)):
        _close(g_[0], r_[0])
        _close(g_[1], r_[1])
        assert torch.equal(g_[2], r_[2])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["uniform", "span-repeats", "span-clustered"])
def test_wide_fold_adds_chunk_totals_in_chunk_order(case):
    """Integer values and 0/1 weights make every chunk total exact, so the
    only rounding left is the carry's, chunk by chunk: the plain version,
    which adds each chunk's totals onto the carry in chunk order, is then
    the kernel's result bit for bit, sums included.  Carries near 2**25
    round every odd total, so an add out of chunk order shows."""
    dev = _cuda()
    G, P, C, L = 1_000_000, 2, 11, 2048
    g = torch.Generator().manual_seed(61)
    vals = torch.randint(1, 8, (P, C, L, 1), generator=g).float()
    w = (torch.rand((P, C, L), generator=g) < 0.5).float()
    if case == "uniform":
        gids = torch.randint(0, G, (P, C, L), generator=g)
    elif case == "span-repeats":  # the same 40 ids in every chunk
        gids = torch.where(torch.rand((P, C, L), generator=g) < 0.5,
                           torch.randint(0, 40, (P, C, L), generator=g),
                           torch.randint(0, G, (P, C, L), generator=g))
    else:  # a chunk's ids within 3,000: hundreds of entries a window
        gids = (torch.randint(0, G - 3000, (P, C, 1), generator=g)
                + torch.randint(0, 3000, (P, C, L), generator=g))
    big = float(2 ** 25)
    cs = big + torch.randint(0, 64, (P, G, 1), generator=g).float() * 4
    cq, cm = cs.clone(), cs[..., 0].clone()
    args = [t.to(dev) for t in (vals, w, gids.to(torch.int32), cs, cq, cm)]
    got = FK.group_round_step(*args)
    want = ref.group_round_step(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.gpu
def test_wide_fold_bundle_member_and_tiles_are_bitwise_solo(monkeypatch):
    """At Q15's shape a bundle member equals its solo launch bit for bit,
    beside a scalar and a 4-group member, and so does a step taken in
    several tiles (the last one ragged) against one tile."""
    dev = _cuda()
    G = 1_000_000
    vals, w, gids, cs, cq, cm = _q15_inputs(dev, G, C=13, seed=62)
    q1 = _random_inputs(63, dev, P=2, A=4, G=4, C=13, L=2048)
    members = [(q1[0], q1[1], None, q1[3]), (q1[0], q1[1], q1[2], *q1[4:]),
               (vals, w, gids, cs, cq, cm)]
    P, C, L, _ = vals.shape
    assert ops.group_step_tile(C, L, [(4, 4), (1, G)]) == C
    bundle = FK.bundle_round_step(members)
    solo = FK.group_round_step(vals, w, gids, cs, cq, cm)
    assert all(torch.equal(x, y) for x, y in zip(bundle[2], solo))
    monkeypatch.setattr(ops, "group_step_tile", lambda C_, L_, m_: 5)
    tiled = FK.group_round_step(vals, w, gids, cs, cq, cm)
    tiled_bundle = FK.bundle_round_step(members)
    flat = (vals.reshape(P, C * L, 1), w.reshape(P, -1), gids.reshape(P, -1))
    tiled3 = ops.group_agg(*flat, num_groups=G, block_rows=L)
    monkeypatch.undo()
    one3 = ops.group_agg(*flat, num_groups=G, block_rows=L)
    assert all(torch.equal(x, y) for x, y in zip(tiled, solo))
    assert all(torch.equal(x, y) for x, y in zip(tiled3, one3))
    assert torch.equal(tiled_bundle[0], bundle[0])
    for a, b in zip(tiled_bundle[1:], bundle[1:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _golden_inputs():
    """Fixed inputs of Q15's shape at G = 1,000,000 (P = 2, C = 40, L =
    2048, A = 1; w zero on about 96% of the rows), made with numpy so that
    they are the same bytes on every machine, and a 4-group, 4-sum member
    for the bundle."""
    rng = np.random.default_rng(20261018)
    P, C, L, G = 2, 40, 2048, 1_000_000
    vals = (rng.random((P, C, L, 1)) * 1e4).astype(np.float32)
    w = (rng.random((P, C, L)) < 0.04).astype(np.float32)
    gids = rng.integers(0, G, (P, C, L)).astype(np.int32)
    cs = (rng.random((P, G, 1)) * 1e6).astype(np.float32)
    cq = (rng.random((P, G, 1)) * 1e9).astype(np.float32)
    cm = rng.integers(0, 500, (P, G)).astype(np.float32)
    v4 = (rng.random((P, C, L, 4)) * 1e3).astype(np.float32)
    g4 = rng.integers(0, 4, (P, C, L)).astype(np.int32)
    c4 = [(rng.random(s) * 1e6).astype(np.float32) for s in ((P, 4, 4), (P, 4, 4), (P, 4))]
    carry = (rng.random((P, 3)) * 1e6).astype(np.float32)
    return vals, w, gids, cs, cq, cm, v4, g4, c4, carry


def _golden_digests(dev) -> dict:
    """sha256 of the group step's outputs on :func:`_golden_inputs`: K1
    group, K3 from zero, and the bundle [scalar, 4 groups, Q15]."""
    import hashlib

    vals, w, gids, cs, cq, cm, v4, g4, c4, carry = (
        [torch.from_numpy(a).to(dev) for a in x] if isinstance(x, list)
        else torch.from_numpy(x).to(dev) for x in _golden_inputs())
    P, C, L, _ = vals.shape
    G = cm.shape[-1]

    def sha(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    flat = (vals.reshape(P, C * L, 1), w.reshape(P, -1), gids.reshape(P, -1))
    bundle = FK.bundle_round_step([(vals, w, None, carry), (v4, w, g4, *c4),
                                   (vals, w, gids, cs, cq, cm)])
    return {"group": sha(FK.group_round_step(vals, w, gids, cs, cq, cm)),
            "group_agg": sha(ops.group_agg(*flat, num_groups=G, block_rows=L)),
            "bundle": sha([bundle[0], *bundle[1], *bundle[2]])}


#: :func:`_golden_digests` as the parent commit of the wide fold
#: (baea946981c07745c3dcf9a0f871a920526b62a8, a window of 32 ids, seven tiles
#: of chunks) gave them on an NVIDIA H100 80GB HBM3
GOLDEN = {"group": "d90280c9d4ceabe7094be95612c5b7a02881298e43c29fa259e23d95a4e0a3ce",
          "group_agg": "dce6b4e9ac5f903a8644faf0c7644a7937803adde45f1ffe8f6d1b5caf2b859c",
          "bundle": "f2c762d5b59b60ae406ef26bc3777517e977b0336549e309b41021e7adc05274"}


@pytest.mark.gpu
def test_group_step_at_g_one_million_is_bitwise_the_golden_outputs():
    """The group step's outputs at Q15's shape are the bits that the
    32-id window gave on the same inputs: K1 group, K3 and the bundle.
    The digests were recorded from commit
    baea946981c07745c3dcf9a0f871a920526b62a8 on an H100, where the step
    took seven tiles of 32-id windows; here it takes one tile of
    1,024-id windows."""
    dev = _cuda()
    assert _golden_digests(dev) == GOLDEN


@pytest.mark.gpu
def test_wide_fold_counter_counts_members_with_wide_windows():
    """``pfola.fold.wide`` counts 1 a round-slice for a report-like bundle
    (Q6, Q1 by returnflag x linestatus, revenue by supplier over 1,000,000
    suppliers) and 0 for a Q1-only group launch."""
    from repro_torch import obs

    dev = _cuda()
    P, C, L, rounds = 2, 16, 2048, 4
    cols = tpch.generate_lineitem(P * C * L, num_suppliers=5000, seed=5, device="cpu")
    g = torch.Generator().manual_seed(2)
    cols["supp"] = torch.randint(0, 1_000_000, (P * C * L,), generator=g,
                                 dtype=torch.int32)
    shards = {k: v.to(dev) for k, v in randomize.pack_partitions(
        randomize.randomize_global(cols, torch.Generator().manual_seed(1), P),
        chunk_len=L).items()}
    d = float(P * C * L)
    q6 = T.make_sum_gla(tpch.q6_func, tpch.q6_cond((0, 1500)), d_total=d)
    q1 = T.make_groupby_gla(tpch.q1_func, tpch.q1_cond, tpch.q1_group_small,
                            num_groups=4, d_total=d, num_aggs=4)
    q15 = T.make_groupby_gla(tpch.q6_func, tpch.q6_cond((0, 1500)),
                             lambda c: c["supp"], num_groups=1_000_000, d_total=d)

    def wide(glas):
        before = obs.summary()["counters"].get("pfola.fold.wide", 0)
        with obs.recording():
            T.run_queries(T.QuerySpec(glas, rounds=rounds, emit="kernel"), shards,
                          device=dev)
            torch.cuda.synchronize()
        return obs.summary()["counters"].get("pfola.fold.wide", 0) - before

    assert wide([q6, q1, q15]) == rounds
    assert wide([q1]) == 0


def _sparse_inputs(dev, G, keep, A=1, P=2, C=12, L=2048, seed=70):
    """A round-slice whose predicate keeps a share ``keep`` of the rows (w
    zero on the others, their values finite), ids uniform over ``G``,
    random carries: Q15's and Q10's shapes at s > 1."""
    g = torch.Generator().manual_seed(seed)
    vals = torch.rand((P, C, L, A), generator=g) * 1e4
    w = (torch.rand((P, C, L), generator=g) < keep).float()
    gids = torch.randint(0, G, (P, C, L), generator=g, dtype=torch.int32)
    cs = torch.rand((P, G, A), generator=g) * 1e6
    cq = torch.rand((P, G, A), generator=g) * 1e9
    cm = torch.randint(0, 500, (P, G), generator=g).float()
    return [t.to(dev) for t in (vals, w, gids, cs, cq, cm)]


def _check_plain(got, want):
    """Sums within RTOL of the plain version, counters bitwise."""
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert torch.equal(got[2], want[2])


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("G, keep", [(1_000_000, 0.036), (15_000_000, 0.01)],
                         ids=["q15", "q10"])
def test_dropped_rows_group_step_matches_plain_versions(G, keep):
    """At Q15's and Q10's shapes (L = 2048, A = 1, s = 32; w zero on 96% and
    99% of the rows) phase 1 drops the zero-weight rows: K1 group, the K1
    bundle (beside a scalar and a 4-group member) and K3 (alone and in a
    bundle) against their plain versions, every bundle member bitwise its
    solo launch."""
    dev = _cuda()
    vals, w, gids, cs, cq, cm = _sparse_inputs(dev, G, keep)
    P, C, L, A = vals.shape
    assert ops.group_step_span(L, A, G) == 32
    q1 = _random_inputs(71, dev, P=P, A=4, G=4, C=C, L=L)
    solo = FK.group_round_step(vals, w, gids, cs, cq, cm)
    _check_plain(solo, ref.group_round_step(vals, w, gids, cs, cq, cm))
    members = [(q1[0], q1[1], None, q1[3]), (q1[0], q1[1], q1[2], *q1[4:]),
               (vals, w, gids, cs, cq, cm)]
    bundle = FK.bundle_round_step(members)
    assert all(torch.equal(x, y) for x, y in zip(bundle[2], solo))
    assert all(torch.equal(x, y) for x, y in zip(bundle[1], FK.group_round_step(*members[1])))
    flat = (vals.reshape(P, C * L, A), w.reshape(P, -1), gids.reshape(P, -1))
    q1f = (q1[0].reshape(P, C * L, 4), q1[1].reshape(P, -1), q1[2].reshape(P, -1))
    solo3 = ops.group_agg(*flat, num_groups=G, block_rows=L)
    _check_plain(solo3, ref.group_agg(*flat, G, L))
    both = ops.group_agg_bundle([(*q1f, 4), (*flat, G)], block_rows=L)
    assert all(torch.equal(x, y) for x, y in zip(both[1], solo3))
    assert all(torch.equal(x, y)
               for x, y in zip(both[0], ops.group_agg(*q1f, num_groups=4, block_rows=L)))


@pytest.mark.gpu
@pytest.mark.parametrize("A", [1, 2])
def test_dropped_rows_keep_nan_and_inf_under_zero_weight(A):
    """A value of NaN, inf or -inf under w = 0 makes its group's sums NaN
    in the plain version (0·inf is NaN): phase 1 keeps such a row, so the
    kernel's sums are NaN in the same places, and finite elsewhere within
    RTOL; the counters stay bitwise."""
    dev = _cuda()
    G = 1_000_000
    vals, w, gids, cs, cq, cm = _sparse_inputs(dev, G, 0.04, A=A, C=6, seed=72)
    P, C, L, _ = vals.shape
    assert ops.group_step_span(L, A, G) > 1
    g = torch.Generator().manual_seed(73)
    zero = (w == 0).nonzero()
    pick = zero[torch.randperm(len(zero), generator=g)[:30]]
    bad = torch.tensor([float("nan"), float("inf"), float("-inf")], device=dev)
    for i, (p, c, r) in enumerate(pick.tolist()):
        vals[p, c, r, i % A] = bad[i % 3]
    args = (vals, w, gids, cs, cq, cm)
    flat = (vals.reshape(P, C * L, A), w.reshape(P, -1), gids.reshape(P, -1))
    for got, want in ((FK.group_round_step(*args), ref.group_round_step(*args)),
                      (ops.group_agg(*flat, num_groups=G, block_rows=L),
                       ref.group_agg(*flat, G, L))):
        for x, y in zip(got[:2], want[:2]):
            nan = torch.isnan(y)
            assert nan.any() and torch.equal(torch.isnan(x), nan)
            _close(x[~nan], y[~nan])
        assert torch.equal(got[2], want[2])


@pytest.mark.gpu
def test_dropped_rows_chunks_with_every_row_and_with_none():
    """A chunk whose rows are all kept and a chunk with none kept, beside
    sparse ones, against the plain version; a partition with no kept row
    writes no entry, so its carry passes through bitwise, a -0.0 included
    (the one sign the drop keeps where adding +0.0 changed it), and K3's
    sums there stay zero."""
    dev = _cuda()
    G = 1_000_000
    vals, w, gids, cs, cq, cm = _sparse_inputs(dev, G, 0.03, C=5, seed=74)
    P, C, L, A = vals.shape
    w[1, 0] = 1.0  # every row kept
    w[1, 3] = 0.0  # none kept
    w[0] = 0.0  # no row kept in partition 0
    cs[0, :1000] = -0.0
    args = (vals, w, gids, cs, cq, cm)
    got = FK.group_round_step(*args)
    _check_plain(got, ref.group_round_step(*args))
    for out, carry in zip(got, (cs, cq, cm)):
        assert torch.equal(_bits(out[0]), _bits(carry[0]))
    flat = (vals.reshape(P, C * L, A), w.reshape(P, -1), gids.reshape(P, -1))
    got3 = ops.group_agg(*flat, num_groups=G, block_rows=L)
    _check_plain(got3, ref.group_agg(*flat, G, L))
    assert all(not x[0].any() for x in got3)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["group", "group_agg"])
def test_dropped_rows_sort_paths_give_the_same_bits(route):
    """Chunks of partition 0 keep at most ``ops.RANK_SORT_ROWS`` rows (the
    counted sort), those of partition 1 the same rows at the same places
    plus more under larger ids (past it: the radix passes).  The added rows
    sort after the others, so every shared id's run sits at the same
    positions in both: its sums, runs of many rows among them, are the same
    bits whichever sort ordered it."""
    dev = _cuda()
    T_ = ops.RANK_SORT_ROWS
    G, X, P, C, L = 1_000_000, 40, 2, 5, 2048
    g = torch.Generator().manual_seed(75)
    vals = torch.rand((P, C, L, 1), generator=g) * 1e4
    w = torch.zeros((P, C, L))
    gids = torch.randint(X, G, (P, C, L), generator=g, dtype=torch.int32)
    for c, (n0, n1) in enumerate(((T_ // 2, T_ + 1), (T_ - 1, T_ + 1), (T_, T_ + 1),
                                  (T_, 2 * T_), (T_, L))):
        rows = torch.randperm(L, generator=g)
        shared, more = rows[:n0], rows[n0:n1]
        ids = torch.randint(0, X, (n0,), generator=g, dtype=torch.int32)
        for p in range(P):
            gids[p, c, shared] = ids
            w[p, c, shared] = 1.0
            vals[p, c, :, 0] = vals[0, c, :, 0]
        w[1, c, more] = 1.0
    cs, cq = (torch.rand((1, G, 1), generator=g).expand(P, G, 1) for _ in range(2))
    cm = torch.rand((1, G), generator=g).expand(P, G)
    args = [t.contiguous().to(dev) for t in (vals, w, gids, cs, cq, cm)]
    if route == "group":
        got = FK.group_round_step(*args)
        _check_plain(got, ref.group_round_step(*args))
    else:
        flat = (args[0].reshape(P, C * L, 1), args[1].reshape(P, -1), args[2].reshape(P, -1))
        got = ops.group_agg(*flat, num_groups=G, block_rows=L)
        _check_plain(got, ref.group_agg(*flat, G, L))
    for t in got:
        assert torch.equal(_bits(t[0, :X]), _bits(t[1, :X]))


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["pf_group", "pf_group_agg_bundle", "pf_bundle"])
def test_group_step_refuses_a_scratch_table_below_its_layout(entry, monkeypatch):
    """A wrapper whose chunk-table stride is one float short of the kernel's
    layout gets an error before either phase of the group step launches,
    and the call counts no launch."""
    dev = _cuda()
    vals, w, gids, carry, cs, cq, cm = _random_inputs(50, dev, P=2, A=2, G=40,
                                                      C=6, L=512)
    good = ops.group_step_words
    monkeypatch.setattr(ops, "group_step_words", lambda L, A, G: good(L, A, G) - 1)
    before = FK.launch_counts()
    with pytest.raises(RuntimeError, match="invalid argument"):
        if entry == "pf_group":
            FK.group_round_step(vals, w, gids, cs, cq, cm)
        elif entry == "pf_group_agg_bundle":
            P, C, L, A = vals.shape
            m = (vals.reshape(P, C * L, A), w.reshape(P, -1), gids.reshape(P, -1), 40)
            ops.group_agg_bundle([m, m], block_rows=L)
        else:
            FK.bundle_round_step([(vals, w, None, carry),
                                  (vals, w, gids, cs, cq, cm)])
    torch.cuda.synchronize()
    assert _delta(before) == {}


@pytest.mark.gpu
def test_bundle_with_a_one_group_member_equals_solo_launches():
    """K1 bundle holding a G=1 member (one run per chunk) beside 2^13
    buckets and a scalar member: every member bitwise its solo launch."""
    dev = _cuda()
    members = []
    for seed, A, G in ((40, 3, 1), (41, 4, 8192), (42, 1, None), (43, 2, 6)):
        vals, w, gids, carry, cs, cq, cm = _random_inputs(
            seed, dev, P=2, A=A, G=G or 3, C=12, L=2048)
        if G == 1:
            gids = torch.zeros_like(gids)
        members.append((vals, w, None, carry) if G is None
                       else (vals, w, gids, cs, cq, cm))
    got = FK.bundle_round_step(members)
    want = ref.bundle_round_step(members)
    for m, g, r in zip(members, got, want):
        if m[2] is None:
            assert torch.equal(g, FK.scalar_round_step(m[0], m[1], m[3]))
            continue
        assert all(torch.equal(x, y) for x, y in zip(g, FK.group_round_step(*m)))
        _close(g[0], r[0])
        _close(g[1], r[1])
        assert torch.equal(g[2], r[2])


@pytest.mark.gpu
@pytest.mark.parametrize("query", ["q6", "q1-small", "q1-buckets"])
def test_query_on_the_card_matches_the_plain_route(query):
    """The same shards through the kernels (cuda) and the plain versions
    (cpu): counters exact, sums and estimates within RTOL."""
    dev = _cuda()
    P, C, L = 4, 32, 2048
    cols = tpch.generate_lineitem(P * C * L, num_suppliers=5000, seed=4,
                                  device="cpu")
    shards = randomize.pack_partitions(
        randomize.randomize_global(cols, torch.Generator().manual_seed(1), P),
        chunk_len=L)
    d = float(P * C * L)
    if query == "q6":
        gla = T.make_sum_gla(tpch.q6_func, tpch.q6_cond((0, 1500)), d_total=d)
    else:
        kw = (dict(num_groups=4) if query == "q1-small"
              else dict(num_groups=5000, bucket_bits=7))
        grp = tpch.q1_group_small if query == "q1-small" else tpch.q1_group_large
        gla = T.make_groupby_gla(tpch.q1_func, tpch.q1_cond, grp, d_total=d,
                                 num_aggs=4, **kw)
    spec = T.QuerySpec(gla, rounds=8, emit="kernel")
    want = T.run_query(spec, shards, device="cpu")
    got = T.run_query(spec, shards, device=dev)
    stepped = T.Session(spec, shards, device=dev)
    while not stepped.done:
        stepped.step()
    again = stepped.result()
    assert torch.equal(got.final, again.final)  # round by round == whole scan
    _close(got.final.cpu(), want.final)
    for f in ("scanned", "matched"):
        assert torch.equal(getattr(got.snapshots, f).cpu(), getattr(want.snapshots, f))
    _close(got.snapshots.sum.cpu(), want.snapshots.sum)
    _close(got.estimates.estimate.cpu(), want.estimates.estimate)


def _delta(before):
    after = FK.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    dict(A=3, G=37, C=5, L=100),
    dict(A=1, G=5, C=64, L=2048),  # Q3: one sum, 5 segments
    dict(A=4, G=10, C=16, L=2048),  # a [Q6, Q1-small, Q3] stack
], ids=["ragged", "q3", "stack"])
def test_group_agg_matches_plain_version(shape):
    """K3 from zero against its plain version; repeats bitwise-equal."""
    dev = _cuda()
    vals, w, gids, *_ = _random_inputs(2, dev, **shape)
    P, C, L, A = vals.shape
    args = (vals.reshape(P, C * L, A), w.reshape(P, C * L), gids.reshape(P, C * L))
    before = FK.launch_counts()
    got = ops.group_agg(*args, num_groups=shape["G"], block_rows=L)
    again = ops.group_agg(*args, num_groups=shape["G"], block_rows=L)
    want = ref.group_agg(*args, shape["G"], L)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _delta(before) == {"group_agg": 2}


@pytest.mark.gpu
def test_group_agg_bundle_member_equals_its_solo_launch():
    """Rows stacked member after member, ids offset: each member's table
    rows are bitwise what its own launch gives."""
    dev = _cuda()
    P, C, L = 4, 8, 2048
    members = [_random_inputs(s, dev, P=P, A=A, G=G, C=C, L=L)[:3]
               for s, A, G in ((3, 1, 1), (4, 4, 4), (5, 1, 5))]
    solo, vals_cat, w_cat, g_cat, off = [], [], [], [], 0
    for (vals, w, gids), G in zip(members, (1, 4, 5)):
        gids = gids.clamp(0, G - 1)
        v = torch.nn.functional.pad(vals, (0, 4 - vals.shape[-1]))
        solo.append(ops.group_agg(vals.reshape(P, C * L, -1), w.reshape(P, -1),
                                  gids.reshape(P, -1), num_groups=G, block_rows=L))
        vals_cat.append(v.reshape(P, C * L, 4))
        w_cat.append(w.reshape(P, -1))
        g_cat.append((gids + off).reshape(P, -1))
        off += G
    s, q, m = ops.group_agg(torch.cat(vals_cat, 1).contiguous(),
                            torch.cat(w_cat, 1).contiguous(),
                            torch.cat(g_cat, 1).contiguous(),
                            num_groups=off, block_rows=L)
    off = 0
    for (ss, qq, mm), G in zip(solo, (1, 4, 5)):
        A = ss.shape[-1]
        assert torch.equal(s[:, off:off + G, :A], ss)
        assert torch.equal(q[:, off:off + G, :A], qq)
        assert torch.equal(m[:, off:off + G], mm)
        off += G


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [dict(C=5, L=100), dict(C=64, L=2048)],
                         ids=["ragged", "wide"])
def test_shard_chunk_partials_matches_plain_version(shape):
    dev = _cuda()
    vals, w, *_ = _random_inputs(6, dev, A=1, **shape)
    vals = vals[..., 0].contiguous()
    mask = (w * 0 + 1).contiguous()
    mask[:, -1, shape["L"] // 2:] = 0  # a ragged tail
    pred = (vals > 50).float()
    before = FK.launch_counts()
    got = ops.shard_chunk_partials(vals, pred, mask)
    again = ops.shard_chunk_partials(vals, pred, mask)
    want = ref.shard_chunk_partials(vals, pred, mask)
    _close(got[..., :2], want[..., :2])
    assert torch.equal(got[..., 2:], want[..., 2:])
    assert torch.equal(got, again)
    assert _delta(before) == {"shard_chunk_partials": 2}


@pytest.mark.gpu
def test_bundle_members_equal_their_solo_launches():
    """K1 bundle: one launch for every member; each member bitwise-equal to
    its solo K1 launch and within RTOL of the plain version."""
    dev = _cuda()
    members = []
    for seed, A, G in ((7, 1, None), (8, 4, 4), (9, 4, 8192), (10, 4, None),
                       (11, 1, 5)):
        vals, w, gids, carry, cs, cq, cm = _random_inputs(
            seed, dev, P=4, A=A, G=G or 3, C=16, L=2048)
        members.append((vals, w, None, carry) if G is None
                       else (vals, w, gids, cs, cq, cm))
    before = FK.launch_counts()
    got = FK.bundle_round_step(members)
    again = FK.bundle_round_step(members)
    assert _delta(before) == {"fused_round_step/bundle": 2}
    want = ref.bundle_round_step(members)
    for m, g, a, r in zip(members, got, again, want):
        if m[2] is None:
            solo = FK.scalar_round_step(m[0], m[1], m[3])
            assert torch.equal(g, solo) and torch.equal(g, a)
            A = m[0].shape[-1]
            _close(g[:, :2 * A], r[:, :2 * A])
            assert torch.equal(g[:, 2 * A], r[:, 2 * A])
        else:
            solo = FK.group_round_step(*m)
            for x, y, z, rr, i in zip(g, solo, a, r, range(3)):
                assert torch.equal(x, y) and torch.equal(x, z)
                if i == 2:
                    assert torch.equal(x, rr)
                else:
                    _close(x, rr)


@pytest.mark.gpu
def test_bundle_wider_than_one_member_table():
    """More members than one pf_bundle table holds: one launch per
    MAX_BUNDLE_MEMBERS members, each member still bitwise its solo launch."""
    dev = _cuda()
    n = FK.MAX_BUNDLE_MEMBERS + 1
    members = []
    for seed in range(n):
        vals, w, gids, carry, cs, cq, cm = _random_inputs(
            20 + seed, dev, P=2, A=2, G=6, C=4, L=256)
        members.append((vals, w, None, carry) if seed % 2
                       else (vals, w, gids, cs, cq, cm))
    before = FK.launch_counts()
    got = FK.bundle_round_step(members)
    assert _delta(before) == {"fused_round_step/bundle": 2}
    for m, g in zip(members, got):
        if m[2] is None:
            assert torch.equal(g, FK.scalar_round_step(m[0], m[1], m[3]))
        else:
            assert all(torch.equal(x, y)
                       for x, y in zip(g, FK.group_round_step(*m)))


# -- slice 3: decode, K5, K6, streaming ----------------------------------------

def _encoded_cases():
    rng = np.random.default_rng(7)
    shape = (3, 5, 96)
    cases = []
    for n, logical in ((11, "float32"), (128, "float32"), (129, "float32"),
                       (20000, "float32"), (300, "float64"), (40, "int16"),
                       (200, "uint8")):
        vals = np.unique(rng.normal(size=3 * n) * 1000).astype(logical)[:n]
        a = rng.choice(vals, shape)
        cases.append((a, ENC.dict_encoding_for(a)))
    for bits in (1, 2, 4, 8, 12, 16, 32):
        hi = np.iinfo(np.int32).max if bits == 32 else 1 << bits
        a = rng.integers(0, hi, shape[:2] + (96,), dtype=np.int32)
        cases.append((a, ENC.BitPackedEncoding(bits)))
    a = rng.integers(0, 1 << 8, shape, dtype=np.int32).astype(np.int16)
    cases.append((a, ENC.BitPackedEncoding(8, logical_dtype="int16")))
    return cases


@pytest.mark.gpu
def test_decode_matches_plain_version_bitwise():
    """Every code dtype (int8, int16; tables in shared memory and past it,
    1- to 8-byte logical values) and bit width, all in ONE launch."""
    dev = _cuda()
    cases = _encoded_cases()
    phys = [torch.from_numpy(ENC.encode_array(a, e)) for a, e in cases]
    before = FK.launch_counts()
    got = KD.decode([(x.to(dev), e) for x, (_, e) in zip(phys, cases)])
    again = KD.decode([(x.to(dev), e) for x, (_, e) in zip(phys, cases)])
    torch.cuda.synchronize()
    assert _delta(before) == {"decode": 2}
    want = KD.decode([(x, e) for x, (_, e) in zip(phys, cases)])
    for g, h, w, (a, e) in zip(got, again, want, cases):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w), e
        assert torch.equal(g, h)
        assert g.cpu().numpy().tobytes() == a.tobytes(), e


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1000, 3 * 2**20 + 17])
def test_chunk_and_q6_agg_match_plain_versions(n):
    dev = _cuda()
    g = torch.Generator().manual_seed(n)
    sd = torch.randint(0, 2526, (n,), generator=g, dtype=torch.int32)
    dc = torch.randint(0, 11, (n,), generator=g).float() / 100
    qt = torch.randint(1, 4, (n,), generator=g).float()
    ep = torch.rand((n,), generator=g) * 1e5
    m = (torch.rand((n,), generator=g) < 0.9).float()
    params = torch.tensor([420.0, 1500.0, 0.02 - 1e-6, 0.03 + 1e-6, 1.0])
    w = (torch.rand((n,), generator=g) < 0.3).float()
    before = FK.launch_counts()
    for fn, args in ((ops.chunk_agg, (ep, w, m)),
                     (ops.q6_agg, (params, sd, dc, qt, ep, m))):
        on_card = [t.to(dev) for t in args]
        got, again = fn(*on_card), fn(*on_card)
        want = fn(*args)
        assert torch.equal(got, again)
        assert torch.equal(got[2:].cpu(), want[2:])  # counters exact (n < 2**24)
        _close(got[:2].cpu(), want[:2])
    assert _delta(before) == {"chunk_agg": 2, "q6_agg": 2}


def _enc_slice(dev, P=4, C=6, L=256, seed=3):
    cols = tpch.generate_lineitem(P * C * L - 300, seed=seed, device="cpu")
    shards = randomize.pack_partitions(
        randomize.randomize_global(cols, torch.Generator().manual_seed(seed), P),
        chunk_len=L)
    encs = ENC.normalize_encodings({
        "discount": ENC.dict_encoding_for(shards["discount"].numpy()),
        "quantity": ENC.dict_encoding_for(shards["quantity"].numpy()),
        "tax": ENC.dict_encoding_for(shards["tax"].numpy()),
        "shipdate": ENC.BitPackedEncoding(16), "rfls": ENC.BitPackedEncoding(2)})
    return shards, encs


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["scalar", "group", "bundle"])
def test_fused_step_with_encodings_equals_step_on_decoded_columns(kind):
    dev = _cuda()
    shards, encs = _enc_slice(dev)
    src = DS.EncodedSource.from_shards(shards, encs)
    phys = {k: torch.from_numpy(v).to(dev) for k, v in src.slice_cols(0, 6).items()}
    plain = {k: v.to(dev) for k, v in shards.items()}
    d = float(shards["_mask"].sum())
    q6 = T.make_sum_gla(tpch.q6_func, tpch.q6_cond((0, 2000)), d_total=d)
    q1 = T.make_groupby_gla(tpch.q1_func, tpch.q1_cond, tpch.q1_group_small,
                            num_groups=4, d_total=d, num_aggs=4)
    gla = {"scalar": q6, "group": q1, "bundle": T.GLABundle([q6, q1])}[kind]
    st = scan.stack_init(gla, (4,), dev)
    before = FK.launch_counts()
    got = FK.fused_round_step(gla, st, phys, encs)
    assert _delta(before) == {"decode": 1, f"fused_round_step/{kind}": 1}
    want = FK.fused_round_step(gla, st, plain)
    assert _same(got, want)


def _same(a, b):
    """Every leaf of two states (tensors, NamedTuples, tuples) bitwise-equal."""
    la, lb = [], []
    tree_map(la.append, a)
    tree_map(lb.append, b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.gpu
def test_streamed_session_on_the_card_bitwise_resident(tmp_path):
    """npy and encoded sources through the pinned-staging prefetcher on the
    card: every final, snapshot and estimate bitwise the resident run's,
    one decode launch per round on the encoded source."""
    dev = _cuda()
    shards, encs = _enc_slice(dev, C=16)
    d = float(shards["_mask"].sum())
    q6 = T.make_sum_gla(tpch.q6_func, tpch.q6_cond((0, 2000)), d_total=d)
    q1 = T.make_groupby_gla(tpch.q1_func, tpch.q1_cond, tpch.q1_group_small,
                            num_groups=4, d_total=d, num_aggs=4)
    npy = DS.NpyMmapSource(DS.NpyMmapSource.save(shards, tmp_path / "npy"))
    enc = DS.EncodedSource(DS.EncodedSource.save(shards, tmp_path / "enc", encs))
    for gla in (q6, q1, T.GLABundle([q6, q1])):
        spec = T.QuerySpec(gla, rounds=8, emit="kernel")
        base = T.Session(spec, shards, device=dev)
        while not base.done:
            base.step()
        want = base.result()
        for src, decodes in ((npy, 0), (enc, 8)):
            before = FK.launch_counts()
            sess = T.Session(spec, src, device=dev)
            got = sess.run()
            torch.cuda.synchronize()
            delta = _delta(before)
            assert delta.pop("decode", 0) == decodes
            assert list(delta.values()) == [8]
            assert _same(got.final, want.final)
            assert _same(got.snapshots, want.snapshots)
            assert _same(got.estimates, want.estimates)
            assert sess.io_stats["slices"] == 8 and sess.io_stats["copy_ms"] > 0


# -- pf_scalar's two load paths and fold tiles; pf_decode's vectors and tails --

def _shifted(t):
    """A copy of ``t`` whose first element sits 4 bytes past a 16-byte
    boundary: a contiguous view one element into a larger buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape).copy_(t)
    assert v.data_ptr() % 16 == t.element_size()
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("A", [1, 3, 9])
def test_scalar_kernels_on_a_misaligned_view_equal_an_aligned_copy(A):
    """vals and w one float past a 16-byte boundary take the 4-byte loads,
    an aligned copy the 16-byte ones (A = 9: column groups): the same rows
    per thread, so K1 scalar and K2 give the same bits."""
    dev = _cuda()
    vals, w, _, carry, *_ = _random_inputs(40, dev, P=3, A=A, C=7, L=2048)
    mv, mw = _shifted(vals), _shifted(w)
    assert vals.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    assert torch.equal(FK.scalar_round_step(mv, mw, carry),
                       FK.scalar_round_step(vals, w, carry))
    assert torch.equal(FK.scalar_prefix(mv, mw), FK.scalar_prefix(vals, w))


@pytest.mark.gpu
@pytest.mark.parametrize("A,C", [(1, 14336), (3, 14401), (1, 1), (9, 300)],
                         ids=["q6-shard-chunks", "A3-ragged-tile", "one-chunk", "A9"])
def test_scalar_fold_across_tiles_matches_plain_versions(A, C):
    """K2 and K1 scalar with the partition's chunk totals taking several
    fold tiles (the last one ragged), one tile, and one chunk: counters
    exact, sums within RTOL, repeats bitwise."""
    dev = _cuda()
    vals, w, _, carry, *_ = _random_inputs(41, dev, P=2, A=A, C=C, L=64)
    k2, r2 = FK.scalar_prefix(vals, w), ref.scalar_prefix(vals, w)
    _close(k2[..., :2 * A], r2[..., :2 * A])
    assert torch.equal(k2[..., 2 * A], r2[..., 2 * A])
    k1, r1 = FK.scalar_round_step(vals, w, carry), ref.scalar_round_step(vals, w, carry)
    _close(k1[:, :2 * A], r1[:, :2 * A])
    assert torch.equal(k1[:, 2 * A], r1[:, 2 * A])
    assert torch.equal(k2, FK.scalar_prefix(vals, w))
    assert torch.equal(k1, FK.scalar_round_step(vals, w, carry))


@pytest.mark.gpu
def test_scalar_carry_is_added_before_the_chunk_totals():
    """Each chunk total (1) added onto a carry of 2**24 rounds away; added
    to each other first, they would not."""
    dev = _cuda()
    P, C, L = 2, 4, 64
    big = float(2 ** 24)
    vals = torch.ones((P, C, L, 1), device=dev)
    w = torch.zeros((P, C, L), device=dev)
    w[..., 0] = 1.0
    carry = torch.full((P, 3), big, device=dev)
    got = FK.scalar_round_step(vals, w, carry)
    assert torch.equal(got, torch.full_like(carry, big))
    assert torch.equal(got, ref.scalar_round_step(vals, w, carry))


def _raw_decode_cases():
    """(physical, encoding) pairs for every code dtype and value size (codes
    past both ends of the table, which clamp; tables in shared memory and
    past it) and every bit width 1-32 (any word bits), with lengths that
    are no multiple of a 16-byte vector."""
    rng = np.random.default_rng(17)
    cases = []
    for code, n_values in (("int8", 11), ("int8", 128), ("int16", 300),
                           ("int16", 9000)):
        lim = np.iinfo(code)
        codes = rng.integers(-n_values // 4, n_values + n_values // 4, (3, 5, 97))
        codes = torch.from_numpy(codes.clip(lim.min, lim.max).astype(code))
        for logical in ("uint8", "int16", "float32", "float64"):
            if logical.startswith("float"):
                values = (rng.normal(size=n_values) * 1e4).astype(logical)
            else:
                lo = np.iinfo(logical)
                values = rng.integers(lo.min, lo.max + 1, n_values).astype(logical)
            enc = ENC.DictEncoding(values=tuple(values.tolist()), code_dtype=code,
                                   logical_dtype=logical)
            cases.append((codes, enc))
    for bits in range(1, 33):
        words = rng.integers(-2 ** 31, 2 ** 31, (3, 5, 7)).astype(np.int32)
        cases.append((torch.from_numpy(words), ENC.BitPackedEncoding(bits)))
    return cases


def _decode_into(columns, outs):
    """One pf_decode launch of ``columns`` into the given outputs (any
    alignment), with the table layout of ``decode._launch``."""
    import ctypes

    from repro_torch.kernels import _runtime as RT

    table = np.zeros((len(columns), KD._TABLE_COLS), np.int64)
    keep = []
    for i, ((x, enc), y) in enumerate(zip(columns, outs)):
        if isinstance(enc, ENC.DictEncoding):
            tab = enc.table(x.device)
            keep.append(tab)
            table[i] = (0, x.element_size(), tab.element_size(), tab.numel(), y.numel(),
                        x.data_ptr(), y.data_ptr(), tab.data_ptr(),
                        int(tab.numel() * tab.element_size() <= KD.SMEM_TABLE_BYTES))
        else:
            table[i] = (1, enc.bits, 4, 0, y.numel(), x.data_ptr(), y.data_ptr(), 0, 0)
    lib = KD._lib()
    RT.launch(lib, lib.pf_decode, ctypes.c_void_p(table.ctypes.data), len(columns),
              device=columns[0][0].device, count="decode")


@pytest.mark.gpu
@pytest.mark.parametrize("src,dst", [(0, 0), (1, 0), (0, 1), (1, 1)],
                         ids=["aligned", "src+1", "dst+1", "both+1"])
def test_decode_vectors_tails_and_misaligned_columns_bitwise(src, dst):
    """Every code dtype, value size and bit width, n no multiple of a
    vector, codes or words (src) and outputs (dst) one element past a
    16-byte boundary: bitwise the plain version, and repeat-bitwise."""
    dev = _cuda()
    cases = _raw_decode_cases()
    want = KD.decode(cases)
    cols = [(_shifted(x.to(dev)) if src else x.to(dev), e) for x, e in cases]
    runs = []
    for _ in range(2):
        if dst:
            outs = [_shifted(torch.zeros_like(y, device=dev)) for y in want]
            for i in range(0, len(cols), KD.MAX_COLUMNS):
                _decode_into(cols[i:i + KD.MAX_COLUMNS], outs[i:i + KD.MAX_COLUMNS])
        else:
            outs = KD.decode(cols)
        runs.append(outs)
    torch.cuda.synchronize()
    for g, h, w_, (_, e) in zip(*runs, want, cases):
        assert g.dtype == w_.dtype and torch.equal(g.cpu(), w_), e
        assert torch.equal(g, h), e


# -- slice 6: K1 on carries carried across partition counts; faults and
# elastic resume on the card ---------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["merge", "split"])
def test_k1_on_elastic_carries_matches_plain_versions(layout):
    """K1 scalar and group from carries that scan.merge_carries (8 -> 4
    partitions) or scan.split_carries (8 -> 16: every second child starts
    at zero) made, against their plain versions."""
    dev = _cuda()
    _, _, _, carry, cs, cq, cm = _random_inputs(50, dev, P=8, A=4, G=37, C=1, L=8)
    if layout == "merge":
        fn, P_new = scan.merge_carries, 4
    else:
        fn, P_new = scan.split_carries, 16
    carry, cs, cq, cm = fn((carry * 1e3, cs * 1e3, cq * 1e6, cm), 2)
    carry, cs, cq, cm = (t.contiguous() for t in (carry, cs, cq, cm))
    assert carry.shape[0] == cs.shape[0] == P_new
    vals, w, gids, *_ = _random_inputs(51, dev, P=P_new, A=4, G=37, C=24, L=2048)
    k1 = FK.scalar_round_step(vals, w, carry)
    r1 = ref.scalar_round_step(vals, w, carry)
    _close(k1[:, :8], r1[:, :8])
    assert torch.equal(k1[:, 8], r1[:, 8])
    kg = FK.group_round_step(vals, w, gids, cs, cq, cm)
    rs, rq, rm = ref.group_round_step(vals, w, gids, cs, cq, cm)
    _close(kg[0], rs)
    _close(kg[1], rq)
    assert torch.equal(kg[2], rm)


def _slice6_data(dev, P=8, C=16, L=512):
    cols = tpch.generate_lineitem(P * C * L, seed=9, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    shards = randomize.pack_partitions(randomize.randomize_global(cols, gen, P),
                                       chunk_len=L)
    d = float(P * C * L)
    q6 = T.make_sum_gla(tpch.q6_func, tpch.q6_cond((0, 2000)), d_total=d)
    q1 = T.make_groupby_gla(tpch.q1_func, tpch.q1_cond, tpch.q1_group_small,
                            num_groups=4, d_total=d, num_aggs=4)
    return shards, q6, q1


def _drive(sess):
    while not sess.done:
        sess.step()
    return sess.result()


@pytest.mark.gpu
def test_streamed_partition_loss_on_the_card(tmp_path):
    """A FailingSource over an npy copy through the pinned-staging
    prefetcher: the loss is recorded at round 3 and the run is bitwise the
    resident session injected with that round (K1 group, 8 launches)."""
    from repro_torch import fault as FT

    dev = _cuda()
    shards, _, q1 = _slice6_data(dev)
    npy = DS.NpyMmapSource(DS.NpyMmapSource.save(shards, tmp_path / "npy"))
    spec = T.QuerySpec(q1, rounds=8, emit="kernel")
    want = _drive(T.Session(spec.with_(fault=T.FaultPolicy("single", fail_at={5: 3})),
                            shards, device=dev))
    before = FK.launch_counts()
    sess = T.Session(spec.with_(fault=T.FaultPolicy("single")),
                     FT.FailingSource(npy, {5: 7}), device=dev)
    got = _drive(sess)
    torch.cuda.synchronize()
    assert _delta(before) == {"fused_round_step/group": 8}
    assert sess._fail_at == {5: 3}
    assert _same((got.final, got.snapshots, got.estimates),
                 (want.final, want.snapshots, want.estimates))


@pytest.mark.gpu
@pytest.mark.parametrize("pnew", [4, 16])
def test_elastic_resume_on_the_card(tmp_path, pnew):
    """Paused on 8 partitions, resumed on 4 or 16: the view gathers each
    round-slice on the card (no prefetcher), K1 runs the remaining rounds,
    and the finals are the uninterrupted run's within RTOL (counters
    exact)."""
    dev = _cuda()
    shards, q6, q1 = _slice6_data(dev)
    for gla in (q6, q1):
        spec = T.QuerySpec(gla, rounds=8, emit="kernel")
        want = _drive(T.Session(spec, shards, device=dev))
        sess = T.Session(spec, shards, device=dev)
        for _ in range(3):
            sess.step()
        sess.pause(tmp_path / "e.ckpt")
        before = FK.launch_counts()
        back = T.Session.resume(tmp_path / "e.ckpt", gla, shards, partitions=pnew,
                                device=dev)
        got = _drive(back)
        torch.cuda.synchronize()
        assert back._prefetch is None and back._source.device_slices
        assert list(_delta(before).values()) == [5]
        _close(got.final, want.final)
        assert torch.equal(got.snapshots.scanned, want.snapshots.scanned)
        assert torch.equal(got.snapshots.matched, want.snapshots.matched)


# -- partitions across processes: two gloo ranks sharing the card ----------

def _gloo_rank(rank, store, out):
    """One of two gloo ranks on the card: K1 on its half of a round-slice,
    and Q6 / Q1 sessions on emit='kernel' over its block, with its launch
    counts."""
    import pickle

    from repro_torch import sharded

    dev = torch.device("cuda", 0)
    mesh = sharded.init_partition_group("gloo", f"file://{store}", rank, 2, dev,
                                        timeout=120)
    try:
        shards, q6, q1 = _slice6_data(dev)
        lo, hi = mesh.bounds(8)
        block = {k: v[lo:hi].contiguous() for k, v in shards.items()}
        res = {"k1": {}, "sessions": {}, "launches": {}}
        for name, gla in (("q6", q6), ("q1", q1)):
            args = FK._member_args(gla.fused, scan.stack_init(gla, (hi - lo,), dev),
                                   {k: v[:, :2] for k, v in block.items()})
            res["k1"][name] = (FK.scalar_round_step(args[0], args[1], args[3])
                               if args[2] is None else FK.group_round_step(*args))
            before = FK.launch_counts()
            res["sessions"][name] = _drive(T.Session(
                T.QuerySpec(gla, rounds=8, emit="kernel"), block, mesh=mesh))
            torch.cuda.synchronize()
            res["launches"][name] = _delta(before)
        for k in ("k1", "sessions"):
            res[k] = tree_map(lambda x: x.cpu(), res[k])
    finally:
        mesh.close()
    with open(out, "wb") as f:
        pickle.dump(res, f)


@pytest.mark.gpu
def test_two_gloo_ranks_on_the_card_bitwise_one_process(tmp_path):
    """Two gloo ranks sharing the card, each with four of eight partitions:
    K1 scalar and group on a rank's partitions bitwise the one-process
    launch's rows (the kernels' per-partition results do not depend on the
    launch's P), and the ranks' Q6 and Q1 sessions bitwise the one-process
    sessions, eight K1 launches a session a rank."""
    import multiprocessing
    import pickle

    dev = _cuda()
    ctx = multiprocessing.get_context("spawn")
    outs = [tmp_path / f"{r}.pkl" for r in range(2)]
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp_path / "store"), str(outs[r])))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0, 0]
    shards, q6, q1 = _slice6_data(dev)
    for r, out in enumerate(outs):
        got = pickle.loads(out.read_bytes())
        lo, hi = 4 * r, 4 * r + 4
        for name, gla in (("q6", q6), ("q1", q1)):
            args = FK._member_args(gla.fused, scan.stack_init(gla, (8,), dev),
                                   {k: v[:, :2] for k, v in shards.items()})
            full = (FK.scalar_round_step(args[0], args[1], args[3])
                    if args[2] is None else FK.group_round_step(*args))
            assert _same(got["k1"][name], tree_map(lambda x: x[lo:hi].cpu(), full))
            want = _drive(T.Session(T.QuerySpec(gla, rounds=8, emit="kernel"), shards,
                                    device=dev))
            assert _same(got["sessions"][name], tree_map(lambda x: x.cpu(), want))
            kname = "fused_round_step/" + ("scalar" if name == "q6" else "group")
            assert got["launches"][name] == {kname: 8}


def _serve_family():
    return T.SlotFamily(
        exprs={"q6": tpch.q6_func, "qty": lambda c: c["quantity"]},
        pred_cols=("shipdate", "discount"),
        groups={"rfls": (tpch.q1_group_small, 4)})


def _bank_step_vs_plain(scan, name):
    """The bank's next K1 bundle launch on its first round-slice against the
    plain version (counters exact, sums within RTOL); returns the launches
    it took."""
    gla, states, path = scan.step_inputs(name)
    assert path == "kernel_fused"
    cols = {k: v[:, :scan.width] for k, v in scan.source.shards.items()}
    args = [FK._member_args(m.fused, st, cols) for m, st in zip(gla.members, states)]
    before = FK.launch_counts()
    got = FK.bundle_round_step(args)
    torch.cuda.synchronize()
    launches = _delta(before)
    for m, a, r in zip(args, got, ref.bundle_round_step(args)):
        if m[2] is None:
            A = m[0].shape[-1]
            _close(a[:, :2 * A], r[:, :2 * A])
            assert torch.equal(a[:, 2 * A], r[:, 2 * A])
        else:
            _close(a[0], r[0])
            _close(a[1], r[1])
            assert torch.equal(a[2], r[2])
    return launches


@pytest.mark.gpu
def test_serving_banks_against_plain_versions():
    """A K=32 scalar bank (two pf_bundle launches of 16 members) and a K=4
    rfls bank, each step held against the plain versions; the scan's own
    step launches ceil(K/16) bundles per bank."""
    from repro_torch import service as SV

    dev = _cuda()
    shards, _, _ = _slice6_data(dev)
    scan = SV.SharedScan(_serve_family(), shards, rounds=8, device=dev)
    for i in range(20):
        scan.attach(T.SlotQuery("q6" if i % 2 else "qty",
                                {"discount": (0.0, 0.005 * (i + 1))}))
    for i in range(3):
        scan.attach(T.SlotQuery("q6", {"shipdate": (300.0 * i, 300.0 * i + 900.0)},
                                group="rfls"))
    assert scan.banks["scalar"].K == 32 and scan.banks["rfls"].K == 4
    assert _bank_step_vs_plain(scan, "scalar") == {"fused_round_step/bundle": 2}
    assert _bank_step_vs_plain(scan, "rfls") == {"fused_round_step/bundle": 1}
    before = FK.launch_counts()
    scan.step()
    torch.cuda.synchronize()
    assert _delta(before) == {"fused_round_step/bundle": 3}


@pytest.mark.gpu
def test_serving_late_join_on_the_card_bitwise_solo_session():
    """A scalar and a group slot joining at round 3 on the card: each
    estimate bitwise a fresh solo Session(emit="kernel") over the ranges
    it witnessed (K1 bundle member vs K1 solo launch)."""
    from repro_torch import service as SV

    dev = _cuda()
    shards, _, _ = _slice6_data(dev)
    fam = _serve_family()
    scan = SV.SharedScan(fam, shards, rounds=8, device=dev)
    scan.attach(T.SlotQuery("q6", {"shipdate": (420.0, 785.0)}))
    for _ in range(3):
        scan.step()
    late = [scan.attach(q) for q in (
        T.SlotQuery("qty", {"discount": (0.02, 0.08)}),
        T.SlotQuery("q6", {"shipdate": (100.0, 2000.0)}, group="rfls"))]
    for _ in range(4):
        scan.step()
    for rec in late:
        view = SV.witnessed_view(shards, rec.witnessed)
        sess = T.Session(T.QuerySpec(fam.solo_gla(rec.query, d_total=scan.d_total),
                                     rounds=4, emit="kernel"), view, device=dev)
        while not sess.done:
            prog = sess.step()
        assert _same(tuple(rec.estimate[:3]), tuple(prog.estimates[:3]))


@pytest.mark.gpu
def test_service_on_the_card_converges_parks_and_unparks():
    """OLAService steps its scan on a worker thread bound to the card: a
    query converges, the scan parks, and the next arrival reuses it."""
    import asyncio

    from repro_torch import service as SV

    dev = _cuda()
    shards, _, _ = _slice6_data(dev)

    async def main():
        async with SV.OLAService(_serve_family(), rounds=8, grace_s=0.05) as svc:
            assert svc.device.type == "cuda" and svc.device.index is not None
            q = T.SlotQuery("q6", {"shipdate": (0.0, 2000.0)})
            out = await (await svc.submit(T.QuerySpec(q, stop=T.rel_width(0.5)),
                                          shards)).result()
            assert out.converged and out.estimate.estimate.device.type == "cpu"
            scan = svc.scan_for(shards)
            await asyncio.sleep(0.3)
            assert svc.is_parked(shards)
            again = await (await svc.submit(q, shards)).result()
            assert svc.scan_for(shards) is scan and again.rounds_witnessed == 8

    asyncio.run(asyncio.wait_for(main(), 120))


def _sketch_trees(d):
    """The [sketch] phase's three sketch trees, at a small size."""
    return {
        "count-distinct": T.CountDistinct(T.Scan(d), lambda c: c["suppkey"], log2m=12),
        "quantile": T.Quantile(T.Filter(T.Scan(d), tpch.q1_cond),
                               lambda c: c["extendedprice"], lo=0.9, hi=105.0,
                               bins=256, q=0.5),
        "heavy-hitters": T.HeavyHitters(T.Scan(d), lambda c: c["quantity"].to(torch.int32),
                                        np.arange(1, 51), width=1024, depth=4)}


@pytest.mark.gpu
@pytest.mark.parametrize("emit,lanes", [("round", 1), ("chunk", 2)])
@pytest.mark.parametrize("name", ["count-distinct", "quantile", "heavy-hitters"])
def test_sketch_states_on_the_card_bitwise_the_cpu(name, emit, lanes):
    """The sketch GLAs on the card (int32 scatter-adds, the float amax, a
    true division for the bin ids) bitwise the CPU port's: states, finals
    and the quantile's bounds; the HLL and CMS estimates within 1e-6."""
    dev = _cuda()
    P, C, L = 4, 8, 256
    cols = tpch.generate_lineitem(P * C * L - 300, seed=5, device="cpu")
    shards = randomize.pack_partitions(
        randomize.randomize_global(cols, torch.Generator().manual_seed(5), P), chunk_len=L)
    runs = []
    for where in ("cpu", dev):
        tree = _sketch_trees(float(P * C * L - 300))[name]
        data = {k: v.to(where) for k, v in shards.items()}
        runs.append(T.run_query(T.QuerySpec(tree, rounds=4, emit=emit, lanes=lanes), data,
                                device=where))
    cpu, card = runs
    for a, b in zip(cpu.snapshots, card.snapshots):
        assert torch.equal(a, b.cpu())
    if name == "quantile":
        assert torch.equal(cpu.final, card.final.cpu())
        for a, b in zip(cpu.estimates[:3], card.estimates[:3]):
            assert torch.equal(a, b.cpu())
    else:
        torch.testing.assert_close(card.final.cpu(), cpu.final, rtol=1e-6, atol=0)
        for a, b in zip(cpu.estimates[:3], card.estimates[:3]):
            torch.testing.assert_close(b.cpu(), a, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_randomize_distributed_on_the_card_keeps_every_row_and_dtype():
    """The two-stage randomization on the card (a card generator, a stable
    sort by target, one ``randperm`` a target): every column the input's
    multiset bitwise with its dtype, every target filled from every origin,
    and a session over its packing bitwise the same session on the CPU over
    the same packed rows."""
    dev = _cuda()
    P, L = 4, 256
    cols = tpch.generate_lineitem(P * 16 * L - 300, seed=9, device=dev)
    n = cols["shipdate"].shape[0]
    cuts = [0, n // 5, n // 2, n // 2, n]  # ragged origins, one without rows
    parts = [{k: v[a:b] for k, v in cols.items()} for a, b in zip(cuts, cuts[1:])]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    out = randomize.randomize_distributed(parts, gen)
    assert len(out) == P and sum(o["shipdate"].shape[0] for o in out) == n
    for k, v in cols.items():
        got = torch.cat([o[k] for o in out])
        assert got.dtype == v.dtype and got.device == v.device
        assert torch.equal(got.sort().values, v.sort().values), k
    packed = randomize.pack_partitions(out, chunk_len=L, min_chunks=16)
    q6 = T.make_sum_gla(tpch.q6_func, tpch.q6_cond(tpch.Q6_LOW_WINDOW), d_total=float(n))
    spec = T.QuerySpec(q6, rounds=8, emit="kernel")
    card = _drive(T.Session(spec, packed, device=dev))
    cpu = _drive(T.Session(spec, {k: v.cpu() for k, v in packed.items()}, device="cpu"))
    assert torch.equal(card.snapshots.matched.cpu(), cpu.snapshots.matched)
    _close(card.final.cpu(), cpu.final)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm_135m", "deepseek_7b", "qwen3_32b", "nemotron_4_15b"])
def test_lm_smoke_model_on_the_card_matches_the_cpu_port(arch):
    """The dense LM (``repro_torch.models``, plain PyTorch) at ``smoke()``
    size with the same float32 weights on the card and on the CPU, TF32 off:
    prefill and 4 decode steps within 1e-4 of max|logit| (float32 sums in
    another order), each step from the CPU's cache copied to the card (an
    int8 entry that rounds the other way moves these logits by up to 6e-4),
    every cache within one bf16 ulp of its max (one int8 step), and greedy
    tokens equal."""
    from repro_torch import serve_step as SS
    from repro_torch.configs import get_config
    from repro_torch.models import spec as MS
    from repro_torch.models import transformer as TT

    def same_cache(ca, cb):
        for x, y in zip(ca, cb):
            for k in x:
                step = 1.0 if x[k].dtype == torch.int8 else 2.0 ** -7 * x[k].float().abs().max().item()
                assert (y[k].cpu().float() - x[k].float()).abs().max().item() <= step + 1e-6, k

    dev = _cuda()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config(arch).smoke()
        params = MS.init_params(TT.param_specs(cfg, torch.float32), torch.Generator().manual_seed(0),
                                "cpu")
        cpu, card = TT.Transformer(cfg, params), TT.Transformer(cfg, _tree_to(params, dev))
        toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))).int()
        pre = SS.make_prefill(cfg, 24)
        (a, ca), (b, cb) = pre(cpu, {"tokens": toks}), pre(card, {"tokens": toks.to(dev)})
        for t in range(5):
            torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4 * a.abs().max().item())
            same_cache(ca, cb)
            tok = torch.argmax(a, -1).int()
            cb = [_tree_to(c, dev) for c in ca]
            a, ca = SS.make_decode(cfg)(cpu, ca, tok, 16 + t)
            b, cb = SS.make_decode(cfg)(card, cb, tok.to(dev), 16 + t)
        g_cpu = SS.greedy_generate(cfg, cpu, {"tokens": toks}, steps=6, cache_len=24)
        g_card = SS.greedy_generate(cfg, card, {"tokens": toks.to(dev)}, steps=6, cache_len=24)
        assert torch.equal(g_card.cpu(), g_cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _k3_member(seed, dev, P, C, L, A, G):
    g = torch.Generator().manual_seed(seed)
    vals = torch.rand((P, C * L, A), generator=g) * 100
    w = (torch.rand((P, C * L), generator=g) < 0.4).float()
    gids = torch.randint(0, G, (P, C * L), generator=g, dtype=torch.int32)
    return vals.to(dev), w.to(dev), gids.to(dev), G


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", [
    [(1, 1), (4, 4), (1, 1_000_000)],  # the report bundle: Q6, Q1, Q15
    [(4, 4), (1, 15_000_000)],  # Q1 beside Q10's customers
], ids=["report", "q10"])
def test_group_agg_bundle_members_equal_solo_and_one_table_launches(shapes):
    """``pf_group_agg_bundle``: each member at its own shape, bitwise its
    solo K3 launch; repeats bitwise; against the plain version within RTOL,
    counters exact.  The one table that stacked every member's groups
    (values padded to the widest member, ids offset) has a wide fold, so
    its phase 1 drops every member's zero-weight rows: a member's rows of
    it are bitwise that member alone at the table's shape, and its own
    launch's bits where that launch drops them too (s > 1), else within
    RTOL (runs of many rows, summed without the zeros), counters exact."""
    dev = _cuda()
    P, C, L = 4, 6, 2048
    members = [_k3_member(i, dev, P, C, L, A, G) for i, (A, G) in enumerate(shapes)]
    before = FK.launch_counts()
    got = ops.group_agg_bundle(members, block_rows=L)
    again = ops.group_agg_bundle(members, block_rows=L)
    torch.cuda.synchronize()
    assert _delta(before) == {"group_agg": 2}
    A_max = max(A for A, _ in shapes)
    off, offs = 0, []
    for _, G in shapes:
        offs.append(off)
        off += G
    padded = [torch.nn.functional.pad(m[0], (0, A_max - m[0].shape[-1])).contiguous()
              for m in members]
    table = ops.group_agg(
        torch.cat(padded, 1).contiguous(),
        torch.cat([m[1] for m in members], 1).contiguous(),
        torch.cat([m[2] + o for m, o in zip(members, offs)], 1).contiguous(),
        num_groups=off, block_rows=L)
    assert ops.group_step_span(L, A_max, off) > 1
    for m, v, o, a, b in zip(members, padded, offs, got, again):
        (vals, w, gids, G), A = m, m[0].shape[-1]
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        solo = ops.group_agg(vals, w, gids, num_groups=G, block_rows=L)
        assert all(torch.equal(x, y) for x, y in zip(a, solo))
        rows = (table[0][:, o:o + G, :A], table[1][:, o:o + G, :A], table[2][:, o:o + G])
        alone = ops.group_agg(v, w, gids, num_groups=off, block_rows=L)
        assert all(torch.equal(x, y) for x, y in zip(
            rows, (alone[0][:, :G, :A], alone[1][:, :G, :A], alone[2][:, :G])))
        if ops.group_step_span(L, A, G) > 1:
            assert all(torch.equal(x, y) for x, y in zip(a, rows))
        else:
            _check_plain(a, rows)
        want = ref.group_agg(vals, w, gids, G, L)
        _close(a[0], want[0])
        _close(a[1], want[1])
        assert torch.equal(a[2], want[2])


@pytest.mark.gpu
def test_join_bundle_takes_one_k3_launch_a_round_slice():
    """[Q6, Q1, revenue by 1,000,000 suppliers, a Q10-like join by
    15,000,000 customers through an orders table, a Q14-like join by a
    part's promotion flag]: the probe tables pass the reference's budget, so
    ``run_queries(emit="kernel")`` takes one K3 launch a round-slice; each
    member's delta of a round-slice is bitwise its solo K3 launch, the group
    members' whole runs bitwise their solo K3 runs; the fold counters count
    every member at its own shape."""
    from repro_torch import obs

    dev = _cuda()
    P, C, L, R = 4, 16, 2048, 4
    rows, n_orders, n_parts, customers = P * C * L, 1 << 20, 1 << 20, 15_000_000
    cols = tpch.generate_lineitem(rows, num_suppliers=5000, seed=9, device="cpu")
    g = torch.Generator().manual_seed(4)
    for k, n in (("orderkey", n_orders), ("partkey", n_parts), ("supp", 1_000_000)):
        cols[k] = torch.randint(0, n, (rows,), generator=g, dtype=torch.int32)
    shards = {k: v.to(dev) for k, v in randomize.pack_partitions(
        randomize.randomize_global(cols, torch.Generator().manual_seed(1), P),
        chunk_len=L).items()}
    cust = torch.randint(0, customers, (n_orders,), generator=g, dtype=torch.int32).to(dev)
    recent = (torch.rand(n_orders, generator=g) < 0.05).to(dev)
    promo = (torch.randint(0, 6, (n_parts,), generator=g) == 5).to(torch.int32).to(dev)
    d = float(rows)
    cond = tpch.q6_cond((0, 1500))
    glas = [
        T.make_sum_gla(tpch.q6_func, cond, d_total=d),
        T.make_groupby_gla(tpch.q1_func, tpch.q1_cond, tpch.q1_group_small, num_groups=4,
                           d_total=d, num_aggs=4),
        T.make_groupby_gla(tpch.q6_func, cond, lambda c: c["supp"], num_groups=1_000_000,
                           d_total=d),
        T.make_join_groupby_gla(tpch.q6_func, lambda c: (c["rfls"] == 3).float(),
                                lambda c: c["orderkey"], cust, recent, num_groups=customers,
                                d_total=d, device=dev),
        T.make_join_groupby_gla(tpch.q6_func, cond, lambda c: c["partkey"], promo,
                                torch.ones(n_parts, dtype=torch.bool, device=dev),
                                num_groups=2, d_total=d, device=dev)]
    bundle = T.GLABundle(glas)
    assert not scan.fused_available(bundle)
    before = FK.launch_counts()
    obs.reset()  # the totals of earlier tests' recordings
    with obs.recording():
        res = T.run_queries(T.QuerySpec(glas, rounds=R, emit="kernel"), shards, device=dev)
        torch.cuda.synchronize()
    counters = obs.summary()["counters"]
    obs.reset()
    assert _delta(before) == {"group_agg": R}
    shapes = [(1, 1), (4, 4), (1, 1_000_000), (1, customers), (1, 2)]
    assert counters["pfola.fold.wide"] == 2 * R  # Q15's and Q10's windows
    assert counters["pfola.fold.visits"] == R * ops.group_step_visits(P, C // R, L, shapes)

    sl = {k: v[:, :C // R] for k, v in shards.items()}
    for m, delta in zip(glas, scan.bundle_round_deltas(bundle, sl)):
        v, w, gi, G = scan.kernel_operands(m, sl)
        s, q, mt = ops.group_agg(v, w, gi, num_groups=G, block_rows=L)
        if m.kernel_num_groups is None:
            s, q, mt = s[:, 0], q[:, 0], mt[:, 0]
        assert torch.equal(delta.sum, s) and torch.equal(delta.sumsq, q)
        assert torch.equal(delta.matched, mt)
    for i in (1, 3, 4):
        solo = T.run_query(T.QuerySpec(glas[i].with_(fused=None), rounds=R, emit="kernel"),
                           shards, device=dev)
        assert torch.equal(res[i].final, solo.final)
        for x, y in zip(res[i].snapshots, solo.snapshots):
            assert torch.equal(x, y)
