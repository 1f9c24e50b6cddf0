"""Synthetic token streams for the LM serving and eval paths.

Port of ``repro/data/tokens.py``: deterministic, cursor-addressable (a
restart resumes the stream at an exact position), a Zipf-ish unigram
distribution plus short-range repetition so that small models have
something learnable.  The draws are numpy's, made exactly as the reference
makes them, so the port yields the reference's tokens bit for bit; only
the final conversion differs (tensors on ``device``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device


def _zipf_probs(vocab: int, alpha: float = 1.1):
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = r ** (-alpha)
    return p / p.sum()


def token_batches(cfg, batch: int, seq: int, *, start: int = 0, seed: int = 0,
                  device="cuda", dtype=torch.int32):
    """Generator of ({"tokens": [B, S]}, next_cursor) with stable cursors.

    ``tokens`` is ``dtype`` (int32, as the reference's, or int64) on
    ``device``; a config with a vision frontend also gets ``patches``
    [B, vis_tokens, d], an encoder-decoder ``frames`` [B, encoder_seq, d],
    float32 from the same generator after the tokens, as in the reference."""
    dev = resolve_device(device)
    probs = _zipf_probs(cfg.vocab_size)
    cursor = start
    while True:
        rng = np.random.default_rng(seed * 1_000_003 + cursor)
        toks = rng.choice(cfg.vocab_size, size=(batch, seq), p=probs)
        # inject copy structure: second half repeats the first half shifted
        half = seq // 2
        toks[:, half:half * 2] = toks[:, :half]
        batch_dict = {"tokens": torch.from_numpy(toks).to(dtype).to(dev)}
        if cfg.frontend == "vision_stub":
            frames = rng.normal(size=(batch, cfg.vis_tokens, cfg.d_model))
            batch_dict["patches"] = torch.from_numpy(frames.astype(np.float32)).to(dev)
        if cfg.is_encoder_decoder:
            fr = rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model))
            batch_dict["frames"] = torch.from_numpy(fr.astype(np.float32)).to(dev)
        cursor += 1
        yield batch_dict, cursor
