"""How far float32 rounding alone moves the port's LM gradients: one
``value_and_grad`` of a config's loss in float32 and in float64 from the
same weights and tokens, on the CPU, and each parameter leaf's
max|g32 - g64| / max|g64|.

    PYTHONPATH=src python tools/lm_grad_floor.py --arch smollm_135m --batch 2 --seq 128
    PYTHONPATH=src python tools/lm_grad_floor.py --arch smollm_135m --layers 2 --batch 2 --seq 256

The weights are ``transformer.init_model``'s from ``--seed``; the reference's
init rule takes a stacked leaf's layer count as its fan-in, so a depth cut
changes every layer's weights, and with them how much the attention's
near one-hot rows amplify rounding.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import token_batches
from repro_torch.models import transformer as TT
from repro_torch.training import train_step as TS
from repro_torch.uda import tree_map


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth (default: uncut)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=12)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    m32 = TT.init_model(cfg, seed=args.seed, dtype=torch.float32, device="cpu").requires_grad_(True)
    m64 = TT.Transformer(cfg, tree_map(lambda t: t.detach().double(), m32.params))
    batch, _ = next(token_batches(cfg, args.batch, args.seq, seed=args.seed, device="cpu"))
    (l32, _), g32 = TS.value_and_grad(m32, cfg, batch)
    (l64, _), g64 = TS.value_and_grad(m64.requires_grad_(True), cfg, batch)
    worst = 0.0
    for (path, a), (_, b) in zip(_paths(g32), _paths(g64)):
        rel = ((a.double() - b).abs().max() / b.abs().max()).item()
        worst = max(worst, rel)
        print(f"{path:32s} {rel:.3e}")
    print(f"arch={cfg.name} layers={cfg.num_layers} tokens={args.batch}x{args.seq} "
          f"loss32={l32.item():.6f} loss64={l64.item():.6f} max_rel={worst:.3e}")
    return worst


if __name__ == "__main__":
    main()
