"""LM serving: batched prefill and greedy decode over the transformer.

Port of ``repro/serving/serve_step.py`` (and of the demo
``examples/llm_serve_demo.py`` as :func:`main`).  Three entry points:

  make_prefill(cfg, cache_len)(model, batch)       -> (last_logits, cache)
  make_decode(cfg)(model, cache, token, pos)       -> (logits, cache)
  greedy_generate(cfg, model, batch, steps=, cache_len=) -> tokens [B, steps]

``model`` is a ``repro_torch.models.transformer.Transformer`` (the
reference passes its parameter tree); it holds the weights on one device.
The decode step updates the cache in place.  Logits and ``argmax`` run over
the padded vocabulary, as in the reference.

    python -m repro_torch.serve_step --arch smollm_135m            # on the card
    python -m repro_torch.serve_step --arch qwen3_32b --smoke --device cpu
    python -m repro_torch.serve_step --arch whisper_base --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import token_batches
from repro_torch.models.transformer import init_model


def make_prefill(cfg: ArchConfig, cache_len: int):
    def prefill_step(model, batch: Dict[str, torch.Tensor]):
        x, _, cache = model.forward(batch, cache_len=cache_len)
        logits = model.unembed(x[:, -1]).to(torch.float32)
        return logits, cache

    return prefill_step


def make_decode(cfg: ArchConfig):
    def decode_step(model, cache, token, pos):
        return model.decode_step(token, cache, pos)

    return decode_step


def prefix_len(cfg: ArchConfig, batch) -> int:
    """Positions the frontend puts before the text: the vision stub's
    ``vis_tokens`` when the batch has ``patches``, else 0."""
    return cfg.vis_tokens if cfg.frontend == "vision_stub" and "patches" in batch else 0


def greedy_generate(cfg: ArchConfig, model, batch, *, steps: int, cache_len: int):
    """Greedy generation: one prefill, then ``steps - 1`` decode steps on
    the host loop; returns the ``steps`` chosen tokens [B, steps] int32.
    With a vision stub's ``patches`` in the batch the prefill's sequence is
    the ``vis_tokens`` patches and then the text, so decoding starts after
    both."""
    prefill, decode = make_prefill(cfg, cache_len), make_decode(cfg)
    logits, cache = prefill(model, batch)
    pos0 = batch["tokens"].shape[1] + prefix_len(cfg, batch)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for i in range(steps - 1):
        logits, cache = decode(model, cache, tok, pos0 + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = init_model(cfg, seed=0, dtype=torch.float32 if args.smoke else torch.bfloat16,
                       device=dev)
    batch, _ = next(token_batches(cfg, args.batch, args.prompt_len, device=dev))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = greedy_generate(cfg, model, batch, steps=args.gen,
                          cache_len=prefix_len(cfg, batch) + args.prompt_len + args.gen + 1)
    sync()
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={dev} generated [{args.batch}, {args.gen}] tokens "
          f"in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
