"""BENCHMARK.json against the benchmark's contract, every file found by
name, and a traffic mix added as data alone."""
import json
import re
import shutil

import pytest

from olabench import bench
from olabench.tests.tiny import ROOT, run_tiny

B = bench.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["paths"] == ["olabench"]
    assert all(not w.startswith("/") and ".." not in w for w in B["command"])
    assert 1 <= B["run_seconds"] <= 51
    assert 2 + 14 * 24 <= 43200 and (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs_cells_and_metrics_keep_to_the_contract():
    names = [c["name"] for c in B["configs"]]
    assert len(set(names)) == len(names)
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    srcs = [c["source"] for c in B["configs"]]
    assert len(set(srcs)) == len(srcs)
    cells = B["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    metrics = B["end_to_end"] + B["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in B["end_to_end"])
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("w", [w["name"] for w in B["workloads"]])
def test_every_cell_resolves_and_reports_enough(w):
    c = bench.cell(w)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert set(c.limits) and all(isinstance(v, (int, float)) for v in c.limits.values())
    for m in c.per_layer:
        assert bench.reader_path(m["name"]).is_file()
        moved = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
        assert w in moved.get("workloads", [w])


def test_a_mix_added_as_data_alone_runs(tmp_path):
    """A later change adds a mix by adding a traffic file, a limits file and
    entries in BENCHMARK.json: no file of the harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "olabench", root / "olabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "olabench" / "traffic" / "q6-dashboard.json").write_text(json.dumps({
        "kind": "service", "streams": {"10": 2}, "queries": ["q6"], "think_s": 0,
        "warmup_cycles": 2, "check_samples": 4}))
    (root / "olabench" / "limits" / "sf10-dashboard.json").write_text(
        (ROOT / "olabench" / "limits" / "sf10-analyst.json").read_text())
    b["workloads"].append({"name": "sf10-dashboard", "config": "tpch-sf10",
                           "traffic": "q6-dashboard", "chips": 1, "why": "throwaway"})
    b["end_to_end"].append({"name": "certified_qps", "unit": "queries/s", "better": "higher",
                            "bound": 0.25, "source": "host_clock", "workloads": ["sf10-dashboard"]})
    b["per_layer"].append({"name": "step_ms.analyst", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "serving", "moves": "certified_qps",
                           "workloads": ["sf10-dashboard"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    out = run_tiny("sf10-dashboard", root=root)
    assert out["correct"] and out["attempted"] > 0
    assert {"certified_qps", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("config", [c["name"] for c in B["configs"]])
def test_analyst_streams_follow_the_scale_factor_and_the_seed(config):
    """TPC-H §5.3.4's least stream count at the configuration's scale factor;
    each stream's queries are the seed's alone and hold every kind in turn."""
    import itertools

    from olabench.service_loop import Driver, stream_count
    from olabench.tests.tiny import analyst_cell

    c = analyst_cell()
    c = c._replace(config=bench.load_json(ROOT / "olabench" / "configs" / f"{config}.json"))
    want = {1: 2, 10: 3, 30: 4, 100: 5, 300: 6, 1000: 7}[c.config["scale_factor"]]
    assert stream_count(c.traffic, c.config) == want

    def firsts(seed):
        d = Driver(c, seed, None, None)
        return [list(itertools.islice(d.stream_queries(s), 9)) for s in range(want)]

    a = firsts(2**31 + 17)
    assert a == firsts(2**31 + 17) and a != firsts(2**31 + 18)
    for qs in a:
        kinds = [q.kind for q in qs]
        assert sorted(kinds[:3]) == sorted(c.traffic["queries"]) and kinds[:3] == kinds[3:6]
