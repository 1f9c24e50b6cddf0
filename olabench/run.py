"""Run one cell of the benchmark once and print its result line.

    python3 -m olabench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  Set-up makes the cell's table on the card from the seed, loads it
through the port's own path (``randomize.randomize_global``, then
``pack_partitions``) and warms every shape the traffic uses; then the
traffic runs for ``--seconds``; then the program's state is freed and the
plain reference (``reference.py``) checks a sample of the answers drawn
from the seed.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit (also the last lines on standard error).
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: top-level modules that may not be loaded in the process that reports:
#: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: Path = ROOT) -> None:
    """Kernel build caches at fixed paths inside the checkout (the port's
    nvcc builds go to ``build/repro_torch`` by themselves)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def say(*words) -> None:
    print(*words, file=sys.stderr, flush=True)


#: the traffic kinds whose drivers predate :func:`driver_module`'s rule
DRIVERS = {"passes": "olabench.passes", "service": "olabench.service_loop"}
DRIVER_NAME = re.compile(r"^[a-z_][a-z0-9_]*$")


def driver_module(kind: str):
    """The driver of a traffic ``kind``: ``olabench/drivers/<kind>.py``, so
    that a later cell brings a driver as a new file; ``passes`` and
    ``service`` keep theirs (:data:`DRIVERS`)."""
    name = DRIVERS.get(kind)
    if name is None:
        if not DRIVER_NAME.match(kind):
            raise ValueError(f"traffic kind {kind!r} names no driver module")
        name = f"olabench.drivers.{kind}"
    return importlib.import_module(name)


def load_table(config: dict, seed: int, device):
    """The configuration's tables from ``seed``: (the scanned table loaded
    as the port loads it, shards ``[P, C, L]`` on ``device``; the tables'
    fingerprint; the dimension tables on ``device``)."""
    import torch

    from olabench import data, tables
    from repro_torch import randomize

    a, tm = config["assumed"], tables.module(config)
    cols = tm.generate(config, seed, device)
    fp = data.fingerprint(cols, tm.COLUMNS)
    g = torch.Generator(device=device)
    g.manual_seed(data.perm_seed(seed))
    parts = randomize.randomize_global(cols, g, int(a["partitions"]))
    del cols
    shards = randomize.pack_partitions(parts, chunk_len=int(a["chunk_len"]))
    del parts
    C = shards["_mask"].shape[1]
    if C % int(a["rounds"]):
        raise ValueError(f"the table packs into C={C} chunks, which {a['rounds']} "
                         "rounds do not divide: the scan would degrade its rounds")
    dims = tm.dimensions(config, seed, device)
    fp.update(tables.dim_fingerprint(dims))
    return shards, fp, dims


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float = T_PROCESS, control: bool = False, plant=None) -> dict:
    """One run of ``cell`` on ``device``: the result line's object.  With
    ``control`` the object also holds ``control``: the numbers the
    bfloat16 control reads on the same sample; ``plant(shards)`` plants a
    fault in the loaded table (both for calibration, not part of a run)."""
    import torch

    from olabench import bench, data, queries, tables
    from olabench.trace import Tracer

    cfg, a = cell.config, cell.config["assumed"]
    queries.load(cell.traffic.get("query_modules", ()))
    mod = driver_module(cell.traffic["kind"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    shards, fp, dims = load_table(cfg, seed, device)
    if plant is not None:
        plant(shards)
    drv = mod.Driver(cell, seed, device, shards, dims)
    del shards, dims
    tracer = Tracer(device) if trace else None
    res = drv.run(seconds, tracer)
    setup_s = res["t_start"] - t_process
    if cuda:
        torch.cuda.synchronize(device)
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    picks = drv.sample(seed, int(cell.traffic["check_samples"]), res["t_start"])
    outs, subjects = drv.outputs(picks), drv.subjects(picks)
    drv.release()
    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    rows, conf = int(cfg["rows"]), float(a["confidence"])
    tm = tables.module(cfg)
    cols, dims = tm.check_columns(cfg, seed, device), tm.dimensions(cfg, seed, device)
    same_data = {**data.fingerprint(cols, tm.COLUMNS), **tables.dim_fingerprint(dims)} == fp
    layout = data.Layout(rows, seed, int(a["partitions"]), int(a["chunk_len"]),
                         int(a["rounds"]), device)
    answers = mod.reference_answers(subjects, cols, layout, dims=dims)
    numbers = mod.compare(outs, answers, rows, conf) if picks else {}
    ctl = None
    if control:
        ctl_answers = mod.reference_answers(subjects, cols, layout, "bfloat16", dims=dims)
        ctl = mod.compare(mod.as_outputs(ctl_answers, rows, conf), answers, rows, conf)
    del cols, dims, layout, answers

    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    missing = sorted(set(cell.limits) - set(numbers))
    correct = (bool(picks) and same_data and not missing and res["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    if not same_data:
        say("check data: the regenerated table differs from set-up's")
    if missing:
        say("check missing:", ", ".join(missing))

    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    ctx = dict(res["ctx"], setup_s=setup_s, seconds=seconds)
    if trace:
        summ = tracer.summary()
        ctx["trace"] = summ
        device_info.update(busy_s=summ["busy_s"], window_s=summ["window_s"])
        out["metrics"] = bench.read_metrics(cell.per_layer, ctx)
        out["device"] = device_info
        out["breakdown"] = {"device_ops": summ["device_ops"], "idle_gaps": summ["idle_gaps"]}
    else:
        # ``<quantity>.<qualifier>`` reports the quantity: the qualifier (``.host``
        # for the host-paced cells) gives it a bound of its own
        e2e = dict(res["e2e"], setup_s=setup_s)
        out["metrics"] = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                          for m in cell.end_to_end if m["name"].split(".")[0] in e2e}
        out["device"] = device_info
    out["checks"] = checks
    if ctl is not None:
        out["control"] = ctl
    say(f"run {cell.name} seed {seed} seconds {seconds} trace {int(trace)} "
        f"window_s {ctx['window_s']} setup_s {setup_s} attempted {res['attempted']} "
        f"failed {res['failed']} checked {len(picks)}")
    for k, v in sorted(ctx.items()):
        if k != "trace":
            say(f"ctx {k} {v}")
    for k, c in checks.items():
        say(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()

    from olabench import bench

    if not (ROOT / "src" / "repro_torch").is_dir():
        say("the port (src/repro_torch) is not in this checkout")
        return 2
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    say("card", power_limit())
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        say("loaded in this process, which must not be:", ", ".join(bad))
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
