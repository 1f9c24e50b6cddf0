"""Run ``chip_smoke.py``'s distributed serving job alone, from one checkout.

    python3 tools/serve_dist_ab.py CHECKOUT WORK [EPS]

Spawns the four gloo ranks of ``chip_smoke.py``'s ``serve-svc`` job on one
card, from the ``chip_smoke.py`` and ``src/`` of ``CHECKOUT``, over the npy
copy of the full table in ``WORK/npy`` (made from the seed on first use and
then shared: delete ``WORK`` afterwards, it holds 6.6 GB).  ``EPS`` is the
``[serve-svc-long]`` target (default: the one ``chip_smoke.py`` chose on an
NVIDIA H100 80GB HBM3 at 700 W).  Prints the card, then one JSON line a
phase (``[serve-dist-svc]``, ``[serve-svc-long]``): queries/s, time-to-ε
p50/p99, steps, rank 0's step and send-and-step p50, each rank's collective
seconds and calls a step, and each rank's store-record p50 where the
checkout times them.

Two checkouts compare in one chip call, each run in its own process and in
the order A B B A, e.g. a parent unpacked with ``git archive`` under
``build/``::

    for t in build/parent . . build/parent; do
        python3 tools/serve_dist_ab.py $t build/ab; done; rm -rf build/ab
"""
import json
import subprocess
import sys
import time
from pathlib import Path

# at the top level: the spawned ranks import this module again
CHECKOUT = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
import chip_smoke as CS  # noqa: E402

EPS_LONG = 0.0005151852512332361


def main() -> None:
    import numpy as np
    import torch

    from repro_torch.data import source as DS
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("this script needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build_all()
    work = Path(sys.argv[2]).resolve()
    if not (work / "npy").exists():
        shards = CS.make_data(torch.device("cuda"))
        host = {k: shards[k].cpu().numpy() for k in CS.STREAM_COLS}
        del shards
        torch.cuda.empty_cache()
        DS.NpyMmapSource.save(host, work / "npy")
        del host
    d = work / "dist"  # a fresh store: an old one holds another run's records
    if d.exists():
        for f in d.iterdir():
            f.unlink()
    d.mkdir(parents=True, exist_ok=True)
    eps = float(sys.argv[3]) if len(sys.argv) > 3 else EPS_LONG
    (d / "serve-svc.json").write_text(json.dumps({"eps": eps}))
    ranks = CS.spawn_ranks({"serve-svc": CS.DIST_WORLD}, work)["serve-svc"]
    for name in ("serve-dist-svc", "serve-svc-long"):
        gs = [r["phases"][name] for r in ranks]
        r0, steps = gs[0]["out"], gs[0]["out"]["steps"]
        # send-and-step seconds; a checkout whose service also sent idle
        # messages records (kind, seconds) pairs
        ticks = [t if isinstance(t, float) else t[1] for t in gs[0]["tick_s"]
                 if isinstance(t, float) or t[0] == "step"]
        print(json.dumps({
            "checkout": str(CHECKOUT), "phase": name, "steps": steps,
            "qps": len(r0["t_eps"]) / r0["makespan"],
            "p50_time_to_eps_ms": float(np.percentile(r0["t_eps"], 50) * 1e3),
            "p99_time_to_eps_ms": float(np.percentile(r0["t_eps"], 99) * 1e3),
            "step_ms_rank0_p50": float(np.percentile(gs[0]["step_s"], 50) * 1e3),
            "send_and_step_ms_rank0_p50": float(np.percentile(ticks, 50) * 1e3),
            "collective_s_per_step": [g["collective_s_per_round"] / steps for g in gs],
            "collectives_per_step": [g["collectives"] / steps for g in gs],
            "record_ms_p50": ([float(np.percentile(g["record_s"], 50) * 1e3) for g in gs]
                              if "record_s" in gs[0] else None)}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"seconds={time.perf_counter() - t0:.3f}", flush=True)
