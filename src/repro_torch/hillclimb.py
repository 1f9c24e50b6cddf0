"""Hill-climbing tool: dry-run ONE cell (optionally with config overrides)
and report the three roofline terms against the H100's constants, the peak
memory a device, and the largest bytes contributors — the measurement step
of the hypothesis -> change -> measure loop.

Port of ``repro/launch/hillclimb.py``.  The reference monkeypatches the dry
run's ``get_config``; here the overridden config goes into
``dryrun.build_cell``.  The terms, a device a step:

    compute_s    = flops / mesh.PEAK_FLOPS_BF16
    memory_s     = bytes / mesh.HBM_BW
    collective_s = collective bytes / mesh.NVLINK_BW

(``repro_torch.dryrun``: flops and bytes counted on ``meta``, collective
bytes from the rule table's model; every collective is priced at NVLink's
rate, the ``pod`` axis's inter-node hops included.)

    PYTHONPATH=src python -m repro_torch.hillclimb qwen3_32b train_4k \\
        --set train_microbatches=4 --label mb4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

from repro_torch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

OUT = Path(__file__).resolve().parents[2] / "experiments" / "hillclimb"


def coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return v == "True"
    return v


def run(arch: str, shape: str, overrides: dict, label: str, mesh_kind: str = "single", *,
        smoke: bool = False, mesh=None, out_dir: Path = OUT, top: int = 12) -> dict:
    """One cell's roofline record, written to ``out_dir``; ``mesh`` defaults
    to the production mesh (which opens the fake process group here)."""
    from repro_torch import dryrun as DR
    from repro_torch import mesh as M
    from repro_torch import sharding as SH
    from repro_torch.configs import get_config

    cfg0 = get_config(arch)
    cfg0 = cfg0.smoke() if smoke else cfg0
    cfg = dataclasses.replace(cfg0, **overrides) if overrides else cfg0
    mesh = mesh if mesh is not None else M.make_production_mesh(multi_pod=mesh_kind == "multi")
    cell = DR.build_cell(arch, shape, mesh, cfg=cfg)
    c, mem, secs = DR.measure(cell, mesh, breakdown=True)
    mp = SH.mesh_axis_size(mesh, "model")
    flops, nbytes = c.cost.flops / mp, c.cost.bytes / mp
    coll = DR.collective_model(cell, mesh)
    t_c, t_m, t_n = flops / PEAK_FLOPS_BF16, nbytes / HBM_BW, sum(coll.values()) / NVLINK_BW
    rec = {
        "cell": f"{arch}.{shape}.{mesh_kind}", "label": label, "overrides": overrides,
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
        "dominant": max(("compute", t_c), ("memory", t_m), ("collective", t_n),
                        key=lambda kv: kv[1])[0],
        "flops_per_device": flops, "bytes_per_device": nbytes, "collective_bytes": coll,
        "peak_gb": mem["peak_estimate"] / 1e9, "temp_gb": mem["temp_bytes"] / 1e9,
        "count_s": round(secs, 3),
        "top_bytes": [(k, v / mp) for k, v in c.bytes_breakdown(top)],
    }
    print(json.dumps({k: v for k, v in rec.items() if k != "top_bytes"}, indent=1))
    print("--- top bytes contributors a device (trip-scaled) ---")
    for k, v in rec["top_bytes"]:
        print(f"  {v:.3e}  {k}")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{arch}.{shape}.{label}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="roofline terms of one dry-run cell")
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--set", action="append", default=[], help="cfg override key=value")
    ap.add_argument("--label", default="exp")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    ap.add_argument("--out", default=str(OUT))
    a = ap.parse_args(argv)
    ov = {}
    for kv in getattr(a, "set"):
        k, v = kv.split("=", 1)
        ov[k] = coerce(v)
    run(a.arch, a.shape, ov, a.label, a.mesh, smoke=a.smoke, out_dir=Path(a.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
