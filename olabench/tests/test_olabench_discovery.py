"""BENCHMARK.json against the benchmark's contract, every file found by
name, a traffic mix added as data alone, and a join cell added as new
files alone."""
import json
import os
import re
import shutil
import subprocess
import sys

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


def test_tables_kinds_and_drivers_are_found_by_name():
    from olabench import data, passes, queries as Q, run, service_loop, tables

    assert tables.module({}) is data and data.dimensions({}, 1, "cpu") == {}
    with pytest.raises(ValueError):
        tables.module({"table_module": "os"})
    assert {"q1", "q6", "q15"} <= set(Q.KINDS)
    with pytest.raises(ValueError):
        Q.kind("q99")
    Q.register("q6", Q.KINDS["q6"])  # the same kind again changes nothing
    with pytest.raises(ValueError):
        Q.register("q6", Q.KINDS["q1"])
    with pytest.raises(ValueError):
        Q.load(["os"])
    assert run.driver_module("passes") is passes
    assert run.driver_module("service") is service_loop
    with pytest.raises(ValueError):
        run.driver_module("../passes")
    with pytest.raises(ModuleNotFoundError):
        run.driver_module("no_such_driver")


# a join cell's files, as a later change would add them: a table module
# with a replicated SUPPLIER (TPC-H 3.0.1 §4.2.3: S_NATIONKEY uniform in
# 0..24), a query kind (revenue by the supplier's nation within a region,
# after Q5, through the port's join group-by), a driver, a traffic mix
NEW_FILES = {
    "olabench/nation_tables.py": '''"""TPC-H lineitem beside a replicated SUPPLIER: each supplier's nation."""
import torch

from olabench import data

COLUMNS, generate, check_columns = data.COLUMNS, data.generate, data.check_columns
tiny_cut = data.tiny_cut


def dimensions(config, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed((4 * int(seed) + 2) % data.SEED_MOD)
    return {"s_nationkey": torch.randint(0, 25, (int(config["suppliers"]),), generator=g,
                                         device=device, dtype=torch.int32)}
''',
    "olabench/nation_kinds.py": '''"""Revenue by the supplier's nation in one region over a year (after Q5)."""
from typing import NamedTuple, Tuple

import torch

from olabench import queries as Q, reference as REF

#: N_REGIONKEY of each nation, TPC-H 3.0.1 §4.2.3
REGION = torch.tensor([0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3, 4, 2, 3, 3, 1])


class NationQuery(NamedTuple):
    kind: str
    exprs: Tuple[str, ...]
    ship: Tuple[int, int]
    region: int
    groups: int = 25


def draw(rng, config):
    y = int(rng.choice(Q.Q6_YEARS))
    return NationQuery("nation_revenue", ("sum_disc_price",), (Q.day(y), Q.day(y + 1)),
                       int(rng.integers(5)))


def port_gla(q, d_total, dims):
    import repro_torch as T

    nation = dims["s_nationkey"]
    valid = (REGION.to(nation.device)[nation.long()] == q.region).to(torch.float32)
    lo, hi = q.ship
    return T.make_join_groupby_gla(
        lambda c: c["extendedprice"] * (1 - c["discount"]),
        lambda c: ((c["shipdate"] >= lo) & (c["shipdate"] < hi)).to(torch.float32),
        lambda c: c["suppkey"], nation, valid, num_groups=q.groups, d_total=d_total,
        device=nation.device)


def sums(cols, q, precision, dims):
    dt = REF.DTYPES[precision]
    sd = cols["shipdate"]
    nation = dims["s_nationkey"][cols["suppkey"].long()].long()
    keep = (sd >= q.ship[0]) & (sd < q.ship[1]) & (REGION.to(sd.device)[nation] == q.region)
    ep, dc = cols["extendedprice"].to(dt), cols["discount"].to(dt)
    vals = (ep * (torch.ones((), dtype=dt) - dc)).to(torch.float64)[:, None]
    return REF.accumulate(vals, keep, nation, q.groups)


def columns(q):
    return {"_mask", "shipdate", "extendedprice", "discount", "suppkey"}


def probes(q, dims):
    return {"s_nationkey": 4 * dims["s_nationkey"].numel()}


Q.register("nation_revenue", Q.Kind(draw, port_gla, sums, columns, probes))
''',
    "olabench/drivers/report_join.py": '''"""Exact shared passes of a bundle that holds a join, as ``passes`` runs them."""
from olabench.passes import Driver, as_outputs, compare, reference_answers  # noqa: F401
''',
    "olabench/traffic/report-nation.json": json.dumps({
        "kind": "report_join", "callers": 1, "think_s": 0,
        "bundle": [{"query": "q6"}, {"query": "nation_revenue"}],
        "query_modules": ["olabench.nation_kinds"], "warmup_passes": 2, "check_samples": 3}),
}

JOIN_RUN = '''
import json

from olabench.tests.tiny import run_tiny
from repro_torch.kernels import fused_agg

sound = run_tiny("sf10-nation")
real, seen = fused_agg.bundle_round_step, []


def altered(members):  # the join member's answer, where the launch produces it
    outs = real(members)
    seen.append(len(outs))
    outs[1] = (outs[1][0] * 1.01, *outs[1][1:])
    return outs


fused_agg.bundle_round_step = altered
print(json.dumps({"sound": sound, "altered": run_tiny("sf10-nation"), "seen": seen}))
'''


def test_a_join_cell_added_as_new_files_alone_runs(tmp_path):
    """A later change adds a configuration with a dimension table, a query
    kind that probes it, a driver and a mix by adding files and entries in
    BENCHMARK.json: every file the harness had stays as it is."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "olabench", root / "olabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    copied = sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())
    (root / "src").symlink_to(ROOT / "src")
    files = dict(NEW_FILES)
    cfg = json.loads((ROOT / "olabench" / "configs" / "tpch-sf10.json").read_text())
    files["olabench/configs/tpch-sf10-nation.json"] = json.dumps(dict(
        cfg, name="tpch-sf10-nation", table_module="olabench.nation_tables"))
    files["olabench/limits/sf10-nation.json"] = (
        ROOT / "olabench" / "limits" / "sf10-report.json").read_text()
    for rel, text in files.items():
        assert not (root / rel).exists()
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tpch-sf10-nation", "source": "TPC-H 3.0.1 §4.2.3",
                         "file": "olabench/configs/tpch-sf10-nation.json",
                         "reduced": ["rows"], "why": "throwaway"})
    b["workloads"].append({"name": "sf10-nation", "config": "tpch-sf10-nation",
                           "traffic": "report-nation", "chips": 1, "why": "throwaway"})
    next(m for m in b["end_to_end"] if m["name"] == "rows_per_s.host")["workloads"].append(
        "sf10-nation")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    p = subprocess.run([sys.executable, "-c", JOIN_RUN], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    sound, bad = out["sound"], out["altered"]
    assert sound["correct"] is True and sound["attempted"] > 0, sound
    assert {"rows_per_s.host", "setup_s"} == set(sound["metrics"])
    assert bad["correct"] is False and bad["checks"]["final_gap"]["value"] > 1e-3
    assert out["seen"] and set(out["seen"]) == {2}  # both members in each launch

    for rel in copied:  # what the harness had, byte for byte
        if rel.name != "BENCHMARK.json":
            assert (root / rel).read_bytes() == (ROOT / rel).read_bytes(), rel
    old = json.loads((ROOT / "BENCHMARK.json").read_text())  # and its entries, appended to
    for k in ("configs", "workloads", "per_layer"):
        assert b[k][:len(old[k])] == old[k]
    for m, o in zip(b["end_to_end"], old["end_to_end"], strict=True):
        had = o.get("workloads", [])
        assert dict(m, workloads=m.get("workloads", [])[:len(had)]) == dict(o, workloads=had)


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
