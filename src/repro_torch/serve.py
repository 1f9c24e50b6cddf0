"""OLA service entry point: concurrent anytime queries on one shared scan.

Port of ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.serve --rows 200000 --queries 6 \\
        --qps 20 --eps 0.05 [--device cpu]

Boots a :class:`repro_torch.service.OLAService` over a synthetic TPC-H
lineitem instance (the port's ``tpch`` generator and ``randomize``, made
from ``--seed`` on ``--device``, "cuda" by default), submits a seeded
Poisson stream of slot queries (scalar Q6-style range aggregates and
group-by members) and prints each query's anytime outcome as it converges
or completes a full pass.  All queries ride ONE cyclic scan; each bank of
slots is stepped by one K1 bundle launch a round-slice on the card (the
plain versions on the CPU).
"""
from __future__ import annotations

import argparse
import asyncio
import time


async def _run(args):
    import numpy as np
    import torch

    import repro_torch as T
    from repro_torch import randomize
    from repro_torch._device import resolve_device
    from repro_torch.data import tpch

    dev = resolve_device(args.device)
    cols = tpch.generate_lineitem(args.rows, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    shards = randomize.pack_partitions(
        randomize.randomize_global(cols, gen, args.parts), chunk_len=args.chunk)

    family = T.SlotFamily(
        exprs={"q6": tpch.q6_func, "qty": lambda c: c["quantity"]},
        pred_cols=("shipdate", "discount"),
        groups={"rfls": (tpch.q1_group_small, 4)})

    rng = np.random.default_rng(args.seed)
    # seeded Poisson stream: exponential inter-arrival gaps
    arrivals = np.cumsum(rng.exponential(1.0 / args.qps, size=args.queries))
    service = T.OLAService(family, rounds=args.rounds, grace_s=args.grace, device=dev)
    t0 = time.perf_counter()

    async def one(i):
        await asyncio.sleep(float(arrivals[i]))
        year = int(rng.integers(0, 6)) * 365
        q = T.SlotQuery(
            expr="qty" if i % 3 == 2 else "q6",
            ranges={"shipdate": (float(year), float(year + 730)),
                    "discount": (0.0, 1.0)},
            group="rfls" if i % 4 == 3 else None)
        h = await service.submit(T.QuerySpec(q, stop=T.rel_width(args.eps)), shards)
        out = await h.result()
        head = float(out.estimate.estimate.reshape(-1)[0])
        print(f"  q{i:02d} expr={q.expr:3s} group={q.group or '-':4s} "
              f"t={time.perf_counter() - t0:6.2f}s "
              f"rounds={out.rounds_witnessed} "
              f"converged={str(out.converged):5s} est[0]={head:14.2f}")
        return out

    async with service:
        outs = await asyncio.gather(*(one(i) for i in range(args.queries)))
    scan = service.scan_for(shards)
    n_conv = sum(o.converged for o in outs)
    print(f"served {args.queries} queries ({n_conv} early-converged) on "
          f"{scan.steps_done if scan else 0} shared scan step(s) on {dev}; "
          f"step plan budget {scan.compile_budget() if scan else 0}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve concurrent OLA queries over one shared scan")
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--queries", type=int, default=6)
    ap.add_argument("--qps", type=float, default=20.0,
                    help="Poisson arrival rate (queries/second)")
    ap.add_argument("--eps", type=float, default=0.05,
                    help="per-query relative-width stop threshold")
    ap.add_argument("--grace", type=float, default=0.25,
                    help="idle seconds before the shared scan parks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the scan runs: cuda (the kernels) or cpu "
                         "(their plain versions)")
    args = ap.parse_args(argv)
    asyncio.run(_run(args))


if __name__ == "__main__":
    main()
