"""The assigned input-shape cells and their abstract inputs (no allocation).

Port of ``repro/launch/shapes.py``, with ``meta`` tensors in place of
``ShapeDtypeStruct``s.  Shape table:

    train_4k      seq 4,096   global_batch 256   a train step
    prefill_32k   seq 32,768  global_batch 32    a prefill
    decode_32k    seq 32,768  global_batch 128   a decode step
    long_500k     seq 524,288 global_batch 1     a decode step; runs only
                  for sub-quadratic archs
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig

SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def cell_runnable(cfg: ArchConfig, shape_name: str):
    """(runs?, reason-if-skipped)."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("full quadratic attention; 500K-token decode needs "
                       "sub-quadratic attention (skip noted in DESIGN.md §5)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape_name: str, batch: int = None) -> Dict[str, torch.Tensor]:
    """Abstract batch for train/prefill kinds (``meta`` tensors); ``batch``
    overrides the cell's global batch (the dry run passes one device's)."""
    info = SHAPES[shape_name]
    B, S = info["batch"] if batch is None else batch, info["seq"]
    d = cfg.d_model
    out = {}
    s_txt = S
    if cfg.frontend == "vision_stub":
        s_txt = S - cfg.vis_tokens
        out["patches"] = _meta((B, cfg.vis_tokens, d), torch.bfloat16)
    if cfg.is_encoder_decoder:
        out["frames"] = _meta((B, cfg.encoder_seq, d), torch.bfloat16)
    out["tokens"] = _meta((B, s_txt), torch.int32)
    return out


def decode_specs(cfg: ArchConfig, shape_name: str, batch: int = None):
    """(cache, token, pos) for decode kinds, as ``meta`` tensors: the cache
    is ``transformer.abstract_cache``'s list of per-layer dicts."""
    from repro_torch.models import transformer as T

    info = SHAPES[shape_name]
    B, S = info["batch"] if batch is None else batch, info["seq"]
    cache = T.abstract_cache(cfg, B, S)
    token = _meta((B,), torch.int32)
    pos = _meta((), torch.int32)
    return cache, token, pos
