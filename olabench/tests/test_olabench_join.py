"""The join cell ``sf100-report-join`` at a size a CPU test holds: its tables
follow ``data.generate`` and TPC-H 3.0.1 §4.2.3, its kinds, its needed
bytes, its driver, and the comparison that decides ``correct``, which a
sound run passes and an altered answer and the bfloat16 control do not.

At the tiny size the probe tables fit the reference's fused budget, so the
runs here lower the budget (``fused_agg.REFERENCE_PROBE_BUDGET_BYTES``) to
route the joins as at full size: the bundle takes the legacy path (K3)."""
import numpy as np
import pytest
import torch

from olabench import bench, data, join_kinds as JK, join_tables as J, queries as Q
from olabench import roofline
from olabench.drivers import join_passes as RJ
from olabench.tests.tiny import CPU, SEED, base_cell, run_tiny, tiny_cell

CELL = "sf100-report-join"


@pytest.fixture
def k3(monkeypatch):
    from repro_torch.kernels import fused_agg

    monkeypatch.setattr(fused_agg, "REFERENCE_PROBE_BUDGET_BYTES", 1000)


def _tiny_config():
    return tiny_cell(CELL).config


def test_lineitem_is_data_generates_columns_and_partkey():
    cfg = _tiny_config()
    cols = J.generate(cfg, SEED, CPU)
    plain = data.generate(cfg, SEED, CPU)
    assert set(cols) == set(plain) | {"partkey"} == set(J.COLUMNS) | {"orderkey"}
    for k, v in plain.items():
        assert torch.equal(cols[k], v), k
    assert all(torch.equal(a, b) for a, b in zip(J.check_columns(cfg, SEED, CPU).values(),
                                                  cols.values()))
    pk = cols["partkey"].long() + 1
    assert int(pk.min()) >= 1 and int(pk.max()) <= cfg["parts"]
    price = (cols["quantity"].long() * data.retail_cents(pk)).double() / 100.0
    assert torch.equal(cols["extendedprice"], price.float())
    S = cfg["suppliers"]
    supp = torch.stack([data.supplier_of(pk, torch.full_like(pk, i), S) for i in range(4)])
    assert bool((supp == cols["suppkey"].long()).any(0).all())


def test_orders_and_part_follow_the_spec():
    cfg = _tiny_config()
    cols, dims = J.generate(cfg, SEED, CPU), J.dimensions(cfg, SEED, CPU)
    n = J.orders(cfg["rows"])
    assert {k: v.shape[0] for k, v in dims.items()} == {
        "o_custkey": n, "o_orderdate": n, "p_promo": cfg["parts"]}
    assert all(v.dtype == torch.int32 for v in dims.values())
    cust = dims["o_custkey"].long() + 1  # C_CUSTKEY
    assert int(cust.min()) >= 1 and int(cust.max()) <= cfg["customers"]
    assert not bool((cust % 3 == 0).any())  # §4.2.3: never a multiple of 3
    dense = J.dense_order(cols["orderkey"]).long()
    assert torch.equal(J.dense_order(data.sparse_orderkey(torch.arange(n))), torch.arange(n))
    gap = cols["shipdate"] - dims["o_orderdate"][dense]
    assert int(gap.min()) >= 1 and int(gap.max()) <= 121  # shipdate: orderdate + 1..121
    share = float(dims["p_promo"].double().mean())
    assert abs(share - 1 / 6) < 6 * (1 / 6 * 5 / 6 / cfg["parts"]) ** 0.5
    assert torch.equal(J.dimensions(cfg, SEED, CPU)["o_custkey"], dims["o_custkey"])
    assert not torch.equal(J.dimensions(cfg, SEED + 1, CPU)["o_custkey"], dims["o_custkey"])


def test_the_kinds_draw_the_specs_parameters():
    rng = np.random.default_rng(7)
    cfg = base_cell(CELL).config
    q10s = [Q.draw(rng, "q10", cfg) for _ in range(400)]
    q14s = [Q.draw(rng, "q14", cfg) for _ in range(400)]
    assert {q.dates[0] for q in q10s} == {Q.day(y, m) for y, m in JK.Q10_MONTHS}
    assert len(JK.Q10_MONTHS) == 24 and len(JK.Q14_MONTHS) == 60
    assert {q.dates for q in q10s if q.dates[0] == Q.day(1994, 11)} == {
        (Q.day(1994, 11), Q.day(1995, 2))}
    assert all(q.groups == 15_000_000 for q in q10s) and all(q.groups == 2 for q in q14s)
    assert {q.dates[1] - q.dates[0] for q in q14s} <= {28, 29, 30, 31}


def test_the_bundle_needs_every_column_once_and_each_probed_table_once():
    cell = base_cell(CELL)
    d = RJ.Driver(cell, SEED, CPU, None)
    qs = d.draw()
    assert [q.kind for q in qs] == ["q6", "q1", "q15", "q10", "q14"]
    rows, n = cell.config["rows"], J.orders(cell.config["rows"])
    dims = {"o_custkey": torch.empty((), dtype=torch.int32).expand(n),
            "o_orderdate": torch.empty((), dtype=torch.int32).expand(n),
            "p_promo": torch.empty((), dtype=torch.int32).expand(cell.config["parts"])}
    assert roofline.row_bytes(qs) == 40
    states = sum(2 * 16 * roofline.state_bytes(q, 8) for q in qs)
    assert roofline.pass_bytes(qs, rows, 8, 16, dims) == 40 * rows + 4 * (2 * n + 20_000_000) \
        + states
    slots = 8 * 36_624 * 2048
    assert RJ.group_step_bytes(qs, slots, 8, 16) == slots * (12 + 24 + 12 + 12 + 12) + 4 * 16 * 8 * (
        1 * 3 + 4 * 9 + 1_000_000 * 3 + 15_000_000 * 3 + 2 * 3)


def test_a_sound_run_is_correct_and_reads_its_program_metrics(k3):
    from repro_torch import obs
    from repro_torch.kernels import _runtime as RT

    # a run's readers take the recorder's totals as the traced passes' alone,
    # as in the benchmark's own process: drop what earlier tests recorded
    obs.reset()
    before = RT.DISPATCHES["group_agg"]
    out = run_tiny(CELL, trace=True, seconds=0.5)
    assert out["correct"] is True and RT.DISPATCHES["group_agg"] > before
    assert {"wrapper_host_us.join", "fold_visits_per_round.join"} <= set(out["metrics"])
    assert set(out["metrics"]) <= {m["name"] for m in base_cell(CELL).per_layer}
    cfg = _tiny_config()
    L, rounds = cfg["assumed"]["chunk_len"], cfg["assumed"]["rounds"]
    from repro_torch.kernels import ops

    C = cfg["rows"] // 8 // L // rounds
    shapes = [(1, 1), (4, 4), (1, cfg["suppliers"]), (1, cfg["customers"]), (1, 2)]
    assert out["metrics"]["fold_visits_per_round.join"]["value"] == ops.group_step_visits(
        8, C, L, shapes)


def test_the_control_and_an_altered_join_answer_are_not_correct(k3, monkeypatch):
    out = run_tiny(CELL, control=True)
    limits = base_cell(CELL).limits
    assert out["correct"] is True
    assert any(v > limits[k] for k, v in out["control"].items()), out["control"]

    from repro_torch.kernels import ops

    real, seen = ops.group_agg_bundle, []

    def altered(members, *, block_rows):
        outs = real(members, block_rows=block_rows)
        seen.append(len(outs))
        outs[3] = (outs[3][0] * 1.01, *outs[3][1:])  # Q10, the join by customer
        return outs

    monkeypatch.setattr(ops, "group_agg_bundle", altered)
    bad = run_tiny(CELL)
    assert bad["correct"] is False and bad["checks"]["final_gap"]["value"] > 1e-3
    assert seen and set(seen) == {5}  # every member in each launch


def test_the_driver_refuses_a_program_without_per_member_k3(monkeypatch):
    from repro_torch.kernels import ops

    monkeypatch.delattr(ops, "group_agg_bundle")
    with pytest.raises(RuntimeError, match="group_agg_bundle"):
        RJ._require_per_member_k3()


def test_the_cell_keeps_to_the_contract():
    b = bench.benchmark()
    cfg = next(c for c in b["configs"] if c["name"] == "tpch-sf100-join")
    assert cfg["reduced"] == [] and base_cell(CELL).config["rows"] == 600_037_902
    assert next(w for w in b["workloads"] if w["name"] == CELL)["chips"] == 1
    e2e = {m["name"]: m.get("workloads") for m in b["end_to_end"]}
    assert e2e["rows_per_s"] == ["sf100-report"]  # its runs spread past half of 1%
    assert e2e["rows_per_s.host"] == ["sf10-report", CELL]
    cell = bench.cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"rows_per_s.host", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "scan_roofline.join", "group_step_roofline.join", "wrapper_host_us.join",
        "fold_visits_per_round.join"}
    assert {m["moves"] for m in cell.per_layer} == {"rows_per_s.host"}
