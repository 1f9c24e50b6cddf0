"""The plain reference against aggregates worked out by hand, and the
layout it rebuilds against the port's loading path."""
import math

import pytest
import torch

from olabench import data, queries as Q, reference as REF
from olabench.tests.tiny import CPU

F64 = torch.float64


def _table():
    return {
        "shipdate": torch.tensor([365, 400, 729, 730, 2400, 10], dtype=torch.int32),
        "discount": torch.tensor([0.05, 0.06, 0.04, 0.05, 0.0, 0.07], dtype=torch.float32),
        "quantity": torch.tensor([10.0, 30.0, 23.0, 5.0, 50.0, 24.0]),
        "extendedprice": torch.tensor([100.0, 200.0, 300.0, 400.0, 500.0, 600.0]),
        "tax": torch.tensor([0.01, 0.02, 0.03, 0.04, 0.05, 0.06], dtype=torch.float32),
        "rfls": torch.tensor([0, 1, 2, 3, 0, 1], dtype=torch.int32),
        "suppkey": torch.tensor([1, 2, 3, 8193, 1, 0], dtype=torch.int32),
    }


def test_q6_sums_by_hand():
    # 1993 (days [365, 730)), discount 0.05 +- 0.01, quantity < 24: rows 0 and 2
    q = Q.Query("q6", ("revenue",), (365, 730), (4, 6), 24)
    s = REF.sums(_table(), q)
    rev = [100.0 * float(torch.tensor(0.05)), 300.0 * float(torch.tensor(0.04))]
    assert s.scanned == 6
    assert s.matched.tolist() == [2.0]
    assert s.sum.tolist() == [[sum(rev)]]
    assert s.sumsq.tolist() == [[sum(v * v for v in rev)]]


def test_q1_group_sums_by_hand():
    q = Q.Query("q1", Q.Q1_SUMS, (0, 731), group="rfls", groups=4)
    s = REF.sums(_table(), q)
    t = {k: v.to(F64) for k, v in _table().items()}
    keep = [0, 1, 2, 3, 5]  # shipdate < 731
    want = torch.zeros(4, 4, dtype=F64)
    for i in keep:
        ep, dc, tx = t["extendedprice"][i], t["discount"][i], t["tax"][i]
        want[int(t["rfls"][i])] += torch.stack(
            [t["quantity"][i], ep, ep * (1 - dc), ep * (1 - dc) * (1 + tx)])
    assert torch.equal(s.sum, want)
    assert s.matched.tolist() == [1.0, 2.0, 1.0, 1.0]


def test_q15_revenue_by_supplier_by_hand():
    # 1993-01 .. 1993-03 is days [365, 455): rows 0 and 1; suppkey 1 and 2
    q = Q.Query("q15", ("sum_disc_price",), (365, 455), group="suppkey", groups=9000)
    s = REF.sums(_table(), q)
    t = {k: v.to(F64) for k, v in _table().items()}
    want = torch.zeros(9000, 1, dtype=F64)
    for i in (0, 1):
        want[int(t["suppkey"][i]), 0] += t["extendedprice"][i] * (1 - t["discount"][i])
    assert torch.equal(s.sum, want)
    assert s.matched.sum().item() == 2.0 and s.matched[1].item() == 1.0


def test_q15_draws_a_quarter_from_the_specs_months():
    import numpy as np

    rng = np.random.default_rng(7)
    for _ in range(200):
        q = Q.q15(rng, 100)
        lo, hi = q.ship
        assert Q.day(1993) <= lo <= Q.day(1997, 10) and 89 <= hi - lo <= 92
    assert len(Q.Q15_MONTHS) == 58


def test_the_generator_follows_the_specs_rules():
    """TPC-H §4.2.3: returnflag and linestatus from the dates, extendedprice
    from the part's retail price, four suppliers a part."""
    cfg = {"rows": 200_000, "suppliers": 1000, "parts": 20_000}
    c = data.generate(cfg, 2**31 + 11, CPU)
    rf, sd = c["rfls"], c["shipdate"]
    assert torch.equal(rf == data.RFLS.index("NO"), sd > data.CURRENT)
    received = (rf == data.RFLS.index("AF")) | (rf == data.RFLS.index("RF"))
    assert bool((sd[received] < data.CURRENT).all())  # received by CURRENTDATE
    share = {f: float((rf == i).double().mean()) for i, f in enumerate(data.RFLS)}
    assert 0.004 < share["NF"] < 0.009 and 0.45 < share["NO"] < 0.55
    assert abs(share["AF"] - share["RF"]) < 0.01
    cents = (c["extendedprice"].double() * 100 / c["quantity"].double()).round().long()
    retail = data.retail_cents(torch.arange(1, cfg["parts"] + 1))
    assert bool(torch.isin(cents, retail).all())
    assert int(c["suppkey"].min()) >= 0 and int(c["suppkey"].max()) < cfg["suppliers"]
    assert data.supplier_of(torch.tensor([1]), torch.tensor([1]), 1000).item() == 251
    keys = torch.unique(c["orderkey"])
    assert bool(((keys - 1) % 32 < 8).all())  # the spec's sparse keys
    assert 3.9 < c["orderkey"].numel() / keys.numel() < 4.1  # 1..7 lines an order


def test_estimator_by_hand():
    s = REF.Sums(torch.tensor([[6.0]], dtype=F64), torch.tensor([[14.0]], dtype=F64),
                 torch.tensor([3.0], dtype=F64), 4)
    e = REF.estimate(s, 10, 0.95)
    est = 10 / 4 * 6.0
    var = 10 * (10 - 4) / (4 * 4 * 3) * (4 * 14.0 - 36.0)
    half = 1.959963984540054 * math.sqrt(var)
    assert e.estimate.item() == pytest.approx(est, rel=1e-15)
    assert e.lower.item() == pytest.approx(est - half, rel=1e-12)
    assert e.upper.item() == pytest.approx(est + half, rel=1e-12)
    full = REF.estimate(s._replace(scanned=10), 10, 0.95)
    assert full.lower.item() == full.upper.item() == 6.0
    one = REF.estimate(s._replace(scanned=1), 10, 0.95)
    assert math.isinf(one.lower.item()) and math.isinf(one.upper.item())


def test_gap_rules():
    r = torch.tensor([[1.0, 2.0], [0.0, 1000.0]], dtype=F64)
    assert REF.gap(r.clone(), r) == 0.0
    p = r.clone()
    p[1, 0] = 1e-3  # a group empty in the reference: judged against the median |ref|
    assert REF.gap(p, r) == pytest.approx(1e-3 / 1.0)  # torch's median: the lower middle
    p = r.clone()
    p[0, 0] = float("nan")
    assert REF.gap(p, r) == math.inf
    p = r * (1 + 1e-6)
    assert REF.gap(p, r) == pytest.approx(1e-6)


@pytest.mark.parametrize("rows", [4096, 4093])
def test_layout_is_the_ports_loading_path(rows):
    """The reference rebuilds, from the seed alone, the rows each round of
    each partition holds after ``randomize_global`` and ``pack_partitions``."""
    from repro_torch import randomize

    cfg = {"rows": rows, "suppliers": 100, "parts": 2000}
    seed = 2**31 + 99
    cols = data.generate(cfg, seed, CPU)
    g = torch.Generator(device=CPU)
    g.manual_seed(data.perm_seed(seed))
    shards = randomize.pack_partitions(randomize.randomize_global(cols, g, 8), 64)
    lay = data.Layout(rows, seed, 8, 64, 4, CPU)
    assert shards["_mask"].shape == (8, lay.C, 64)
    seen = []
    for r, rc in data.gather_rounds(cols, lay, range(4)):
        sl = slice(r * lay.W, (r + 1) * lay.W)
        mask = shards["_mask"][:, sl].reshape(-1) > 0
        for k in data.COLUMNS:
            assert torch.equal(shards[k][:, sl].reshape(-1)[mask], rc[k])
        seen.append(lay.round_rows(r))
    assert torch.equal(torch.sort(torch.cat(seen)).values, torch.arange(rows))
    assert lay.round_of(lay.W, 2 * lay.W) == 1
    with pytest.raises(ValueError):
        lay.round_of(1, lay.W + 1)


def test_generation_is_the_seeds_alone():
    cfg = {"rows": 1000, "suppliers": 100, "parts": 2000}
    a, b = data.generate(cfg, 5, CPU), data.generate(cfg, 5, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert data.fingerprint(a) == data.fingerprint(b)
    assert data.fingerprint(a) != data.fingerprint(data.generate(cfg, 6, CPU))
