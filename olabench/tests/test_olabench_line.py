"""The result line's shape, and the runs that must print none."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from olabench.tests.tiny import ROOT, base_cell, run_tiny

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("w", ["sf10-report", "sf10-analyst"])
def test_the_line_holds_the_contracts_keys(w, trace):
    out = run_tiny(w, trace=bool(trace))
    assert out["correct"] is True
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    c = base_cell(w)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(out["metrics"]) <= want and out["metrics"]
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and isinstance(v["value"], float)
    assert set(out["device"]) == DEVICE_KEYS | ({"busy_s", "window_s"} if trace else set())
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in out["breakdown"].values())
    assert set(out["checks"]) == set(c.limits)
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(out)


def _run(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "olabench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    p = _run(ROOT, "--workload", "sf10-report", "--seed", str(2**31 + 5), "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "olabench", tmp_path / "olabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "--workload", "sf10-report", "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""
