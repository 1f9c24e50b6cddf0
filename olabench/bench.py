"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; each is a file of its own
(``configs/<config>.json``, ``traffic/<traffic>.json``), and so is each
cell's correctness limits (``limits/<cell>.json``) and each per-layer
metric's reader (``metrics/<metric>.py``; a ``_host`` twin may share its
quantity's).  A configuration may name the module that makes its tables
(``tables.py``), a traffic mix the modules of its query kinds
(``queries.load``), and a traffic kind is its driver's module
(``run.driver_module``).  A later change adds a cell, a mix, a metric, a
table, a query kind or a driver by adding files and entries, never by
editing these.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its
    configuration, traffic mix, limits and the metrics it reports; a
    KeyError names what is missing."""
    bench = benchmark(root)
    here = root / HERE.name
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(wl)}")
    w = wl[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(load_json(root / configs[w["config"]]["file"]))
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = load_json(here / "limits" / f"{name}.json")
    return Cell(name, config, traffic, limits, int(w["chips"]),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``; for ``<quantity>_host``, the host-paced cells'
    twin of a metric, ``metrics/<quantity>.py`` where it has no file of its own."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file() and name.endswith("_host"):
        path = HERE / "metrics" / f"{name[:-len('_host')]}.py"
    return path


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """The metric's reader's ``read(ctx)`` (:func:`reader_path`): the
    metric's value, or None when the run holds nothing to read it from."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "olabench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], ctx: dict) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
