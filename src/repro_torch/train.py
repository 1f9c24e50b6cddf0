"""Training driver: LM training with checkpoint/restart and the loss as a
running PF-OLA state (an anytime mean with its confidence half-width).

Port of ``repro/launch/train.py``:

    python -m repro_torch.train --arch smollm_135m                 # on the card
    python -m repro_torch.train --smoke --device cpu --steps 20 --ckpt-every 10
    python -m repro_torch.train --smoke --device cpu --steps 40 --resume

The full config trains in bf16 (float32 optimizer state); ``--smoke`` the
reduced same-family config in float32.  Batches come from
``data.tokens.token_batches`` at the checkpoint's cursor, so a resumed run
sees the batches an uninterrupted one would.  Checkpoints go to
``--ckpt-dir`` (default ``build/ckpt`` under the working directory) as
``<arch>.ckpt``.
"""
from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import torch

from repro_torch import ckpt
from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.tokens import token_batches
from repro_torch.models.transformer import Transformer
from repro_torch.training import train_step as TS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model, opt = TS.init_train_state(
        cfg, seed=0, dtype=torch.float32 if args.smoke else torch.bfloat16, device=dev)
    start, cursor = 0, 0
    path = Path(args.ckpt_dir) / f"{args.arch}.ckpt"
    if args.resume and path.exists():
        params, opt, start, cursor = ckpt.load_train_state(path, model.params, opt, device=dev)
        model = Transformer(cfg, params).requires_grad_(True)
        print(f"resumed from step {start}")

    step_fn = TS.make_train_step(cfg, lr=args.lr)
    batches = token_batches(cfg, args.batch, args.seq, start=cursor, device=dev)
    # loss as a running PF-OLA state: anytime mean + CI over the run
    s = sq = n = 0.0
    t0 = time.time()
    for step in range(start, args.steps):
        batch, cursor = next(batches)
        model, opt, m = step_fn(model, opt, batch)
        loss = float(m["loss"])
        s, sq, n = s + loss, sq + loss * loss, n + 1
        if (step + 1) % 10 == 0:
            mean = s / n
            var = max(sq / n - mean * mean, 0.0) / max(n - 1, 1)
            half = 1.96 * math.sqrt(var)
            print(f"step {step + 1:4d} loss {loss:.4f} "
                  f"run-mean {mean:.4f} ±{half:.4f} "
                  f"({(time.time() - t0) / (step - start + 1):.2f}s/step)")
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save_train_state(path, model.params, opt, step + 1, cursor)
            print(f"checkpointed at step {step + 1}")
    ckpt.save_train_state(path, model.params, opt, args.steps, cursor)
    print("done")
    return model, opt


if __name__ == "__main__":
    main()
