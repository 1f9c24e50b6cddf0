"""The bytes a window needs, counted from the queries, and the metric
readers that turn them into shares."""
import pytest
import torch

from olabench import bench, queries as Q, roofline
from olabench.roofline import HBM_BYTES_PER_S


def test_columns_of_each_query():
    q6 = Q.Query("q6", ("revenue",), (365, 730), (4, 6), 24)
    assert roofline.columns(q6) == {"_mask", "shipdate", "discount", "quantity", "extendedprice"}
    q1 = Q.Query("q1", ("sum_qty",), (0, 2500), group="rfls", groups=4)
    assert roofline.columns(q1) == {"_mask", "shipdate", "quantity", "rfls"}
    q1c = Q.Query("q1", ("sum_charge",), (0, 2500), group="rfls", groups=4)
    assert roofline.columns(q1c) == {"_mask", "shipdate", "extendedprice", "discount", "tax",
                                     "rfls"}
    q15 = Q.q15(__import__("numpy").random.default_rng(0), 1000)
    assert roofline.columns(q15) == {"_mask", "shipdate", "extendedprice", "discount",
                                     "suppkey"}


def test_report_bundle_needs_32_bytes_a_row_and_its_states():
    rng = __import__("numpy").random.default_rng(0)
    qs = [Q.q6(rng), Q.q1(rng), Q.q15(rng, 1_000_000)]
    assert roofline.row_bytes(qs) == 32  # 7 columns and the mask
    states = [4 * 8 * 1 * 3, 4 * 8 * 4 * 9, 4 * 8 * 1_000_000 * 3]
    assert [roofline.state_bytes(q, 8) for q in qs] == states
    rows = 600_037_902
    assert roofline.pass_bytes(qs, rows, 8, 16) == 32 * rows + 2 * 16 * sum(states)


def test_a_probed_dimension_column_is_needed_once_a_pass(monkeypatch):
    """A kind's probes count once a pass, once however many members probe
    the same dimension column; the kinds that probe nothing add nothing."""
    rng = __import__("numpy").random.default_rng(0)
    q6 = Q.q6(rng)
    probe = Q.Query("probe", ("sum_disc_price",), (0, 100), group="suppkey", groups=25)
    monkeypatch.setitem(Q.KINDS, "probe", Q.KINDS["q15"]._replace(
        probes=lambda q, dims: {"s_nationkey": 4 * dims["s_nationkey"].numel()}))
    dims = {"s_nationkey": torch.zeros(1000, dtype=torch.int32)}
    rows, P, R = 1_000_000, 8, 16
    assert roofline.probes([q6], dims) == {}
    states = 2 * R * (roofline.state_bytes(q6, P) + roofline.state_bytes(probe, P))
    assert roofline.row_bytes([q6, probe]) == 24  # the mask and 5 columns
    assert roofline.pass_bytes([q6, probe], rows, P, R, dims) == 24 * rows + 4000 + states
    assert roofline.pass_bytes([q6, probe, probe], rows, P, R, dims) == (
        24 * rows + 4000 + states + 2 * R * roofline.state_bytes(probe, P))


def _read(name, ctx):
    return bench.metric_reader(name)(ctx)


def test_shares_from_a_window():
    trace = {"busy_s": 0.5, "window_s": 2.0, "kernels": 640}
    ctx = {"kind": "passes", "window_s": 10.0,
           "traced_needed_bytes": 2 * HBM_BYTES_PER_S * 0.25, "traced_rounds": 32,
           "traced_launches": 32, "trace": trace}
    assert _read("device_idle_share.report", ctx) == pytest.approx(75.0)
    assert _read("device_idle_share.report_host", ctx) == pytest.approx(75.0)
    assert _read("device_idle_share.analyst", ctx) is None
    assert _read("scan_roofline.report", ctx) == pytest.approx(100.0)
    assert _read("device_kernels_per_round.report", ctx) == 20.0
    assert _read("port_launches_per_round.report", ctx) == 1.0
    assert _read("port_launches_per_round.report_host", ctx) == 1.0


READERS = sorted(p.stem for p in (bench.HERE / "metrics").glob("*.py"))


@pytest.mark.parametrize("name", sorted({m["name"] for m in bench.benchmark()["per_layer"]}
                                        | set(READERS)))
def test_every_reader_reads_nothing_where_there_is_nothing(name):
    assert _read(name, {}) is None
    assert _read(name, {"kind": "none of these"}) is None
