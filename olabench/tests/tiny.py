"""Cells cut to a size a CPU test holds: the same files, a table of
4,096 rows in 8 partitions of 8 chunks of 64 rows and 4 rounds."""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from olabench import bench, run, tables  # noqa: E402

SEED = 2**31 + 4321
CPU = torch.device("cpu")


def tiny(cell):
    """The cell at the tiny size: the rows and layout here, the table
    module's own sizes by its ``tiny_cut`` (``tables.py``)."""
    cfg = tables.tiny_cut(dict(cell.config, rows=8 * 64 * 8, assumed=dict(
        cell.config["assumed"], chunk_len=64, rounds=4, certify_eps=0.2)))
    tr = dict(cell.traffic)
    if tr["kind"] == "service":
        tr.update(warmup_cycles=1, check_samples=6)
    else:
        tr.update(warmup_passes=1)
    return cell._replace(config=cfg, traffic=tr)


#: the analysts' cell, whose files the harness holds but BENCHMARK.json does
#: not name (its runs spread too widely for a bound: PERF.md §7), as a later
#: change would add it
ANALYST_E2E = [("certified_qps", "queries/s"), ("setup_s", "s")]
ANALYST_LAYER = [("device_idle_share.analyst", "%"), ("scan_roofline.analyst", "%"),
                 ("step_ms.analyst", "ms"), ("slots_per_step.analyst", "slots"),
                 ("rounds_to_eps_mean.analyst", "rounds"), ("time_to_eps_p95_ms.host", "ms")]


def analyst_cell(root: Path = ROOT) -> bench.Cell:
    here = root / "olabench"
    return bench.Cell("sf10-analyst", bench.load_json(here / "configs" / "tpch-sf10.json"),
                      bench.load_json(here / "traffic" / "analyst.json"),
                      bench.load_json(here / "limits" / "sf10-analyst.json"), 1,
                      [{"name": n, "unit": u} for n, u in ANALYST_E2E],
                      [{"name": n, "unit": u} for n, u in ANALYST_LAYER])


def base_cell(name: str, root: Path = ROOT) -> bench.Cell:
    return analyst_cell(root) if name == "sf10-analyst" else bench.cell(name, root)


def tiny_cell(name: str, root: Path = ROOT):
    return tiny(base_cell(name, root))


def run_tiny(name: str, *, seconds: float = 0.5, trace: bool = False, control: bool = False,
             root: Path = ROOT, seed: int = SEED) -> dict:
    return run.run_cell(tiny_cell(name, root), seed, seconds, trace, CPU, control=control)
