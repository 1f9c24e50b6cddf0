"""The readings the correctness limits and ``certify_eps`` are set from.

    python3 -m olabench.calibrate --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 4,5,6] [--seconds 4] [--eps 600]

runs the cell on the card once a seed, in one process, and prints a JSON
line a seed with the numbers it compared (the program's readings) and, on
the control seeds, the numbers the control reads on the same sample: the
reference put in the program's place and computed in bfloat16.  On the
fault seeds it runs the cell again with a count fault planted in the
loaded table (the mask of partition 0's first chunk cleared, so that
round 0 scans 2,048 rows fewer than the layout holds) and prints what it
reads.  Then one line with the largest program reading and the smallest
control and fault readings of each number.  With ``--eps N`` it instead
draws N queries of the cell's service mix, its kinds in turn, and prints
the median relative half-width of their round-1 estimates (the largest
over a query's sums and groups): ``certify_eps`` is half of it, so that
the median query is certified after about 4 rounds.

None of this is part of a run of the benchmark.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from olabench import run as RUN


def eps_readings(cell, seed: int, n: int, device) -> dict:
    import numpy as np
    import torch

    from olabench import data, queries as Q, reference as REF, tables

    a = cell.config["assumed"]
    rows = int(cell.config["rows"])
    tm = tables.module(cell.config)
    cols = tm.check_columns(cell.config, seed, device)
    dims = tm.dimensions(cell.config, seed, device)
    Q.load(cell.traffic.get("query_modules", ()))
    layout = data.Layout(rows, seed, int(a["partitions"]), int(a["chunk_len"]),
                         int(a["rounds"]), device)
    rng = np.random.default_rng([seed, 3])
    kinds = cell.traffic["queries"]
    qs = [Q.draw(rng, kinds[i % len(kinds)], cell.config) for i in range(n)]
    _, rc = next(data.gather_rounds(cols, layout, [0]))
    rel = {}
    for q in qs:
        e = REF.estimate(REF.sums(rc, q, dims=dims), rows, float(a["confidence"]))
        half = (e.upper - e.lower) / 2
        r = torch.where(half == 0, torch.zeros_like(half), half / e.estimate.abs())
        rel.setdefault(q.kind, []).append(float(r.max()))
    every = [x for v in rel.values() for x in v]
    return {"median_round1_rel_half_width": float(np.median(every)),
            "certify_eps": float(np.median(every)) / 2,
            "by_kind": {k: [float(np.min(v)), float(np.median(v)), float(np.max(v)), len(v)]
                        for k, v in rel.items()}}


def clear_first_chunk(shards) -> None:
    """The count fault: partition 0's first chunk (round 0's) masked out."""
    shards["_mask"][0, 0] = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--eps", type=int, default=0)
    args = ap.parse_args(argv)
    RUN.cache_env()
    import torch

    from olabench import bench

    cell = bench.cell(args.workload)
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.eps:
        print(json.dumps(eps_readings(cell, seeds[0], args.eps, dev)), flush=True)
        return 0
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    lower, upper, fault = {}, {}, {}
    for seed in seeds:
        t = time.perf_counter()
        out = RUN.run_cell(cell, seed, args.seconds, False, dev, t, control=seed in ctl_seeds)
        torch.cuda.empty_cache()
        line = {"seed": seed, "correct": out["correct"],
                "program": {k: c["value"] for k, c in out["checks"].items()},
                "control": out.get("control"), "metrics": out["metrics"]}
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in (out.get("control") or {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
    for seed in fault_seeds:
        t = time.perf_counter()
        out = RUN.run_cell(cell, seed, args.seconds, False, dev, t, plant=clear_first_chunk)
        torch.cuda.empty_cache()
        line = {"seed": seed, "fault": "count", "correct": out["correct"],
                "program": {k: c["value"] for k, c in out["checks"].items()}}
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            fault[k] = min(fault.get(k, float("inf")), v)
    print(json.dumps({"workload": cell.name, "seeds": len(seeds), "lower": lower,
                      "control_seeds": len(ctl_seeds), "upper": upper,
                      "fault_seeds": len(fault_seeds), "fault": fault}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
