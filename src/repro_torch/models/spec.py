"""Parameter specification — shape, logical axes and initialization of every
parameter, as one tree.

Port of ``repro/models/spec.py``.  A model definition builds a tree (nested
dicts) of :class:`ParamSpec`; :func:`init_params` materializes it.  The
logical axis names are the reference's ("embed", "mlp", "heads", "kv",
"vocab", "layers", ...); they mean nothing on one card, and
``repro_torch.sharding``'s rule table reads them (``param_pspecs``).
:func:`abstract_params` gives the tree as ``meta`` tensors, for the dry run
(``repro_torch.dryrun``) to count bytes and operations without memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch._device import resolve_device

#: the largest float32 draw of one ``randn``: a leaf whose draw would be
#: larger is drawn one slice of its leading axis at a time (a full-width
#: expert leaf of llama4-maverick, [128, 5120, 8192], would take 21.5 GB in
#: float32 before its cast to bf16)
SLICE_BYTES = 8 * 2**30


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]  # logical axis per dim (None = no shard)
    init: str = "normal"  # "normal" | "zeros" | "ones" | "embed"
    scale: float = 1.0    # stddev multiplier (fan-in handled per init kind)
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes {self.logical} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_leaves(tree, prefix=""):
    """``(path, spec)`` pairs of a spec tree, depth first over sorted keys —
    the order ``jax.tree.flatten`` gives a tree of dicts, and the draw order
    of :func:`init_params`.  Paths join keys with ``/``."""
    if is_spec(tree):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += spec_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def _init_one(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "embed":
        std = spec.scale
    else:
        # the reference's rule: fan-in is the leading dim — for a leaf
        # stacked over layers that is the layer count, as in the reference
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        std = spec.scale / math.sqrt(fan_in)
    return _draw(spec.shape, std, spec.dtype, generator, device)


def _draw(shape, std: float, dtype, generator: torch.Generator, device) -> torch.Tensor:
    """``randn(shape)`` in float32 times ``std``, cast to ``dtype``; past
    SLICE_BYTES one slice of the leading axis at a time, in order, each by
    the same rule."""
    if 4 * math.prod(shape) <= SLICE_BYTES:
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = _draw(shape[1:], std, dtype, generator, device)
    return out


def init_params(spec_tree, generator: torch.Generator, device="cuda"):
    """Materialize a spec tree as a tree of tensors on ``device``.

    Draw order on ``generator`` (which must live on ``device``): the leaves
    depth first over sorted keys (:func:`spec_leaves`); each ``normal`` or
    ``embed`` leaf draws one ``torch.randn`` of its full shape in float32,
    scaled by its std and cast to its dtype; ``zeros`` and ``ones`` leaves
    draw nothing.  A leaf whose float32 draw would exceed
    :data:`SLICE_BYTES` draws one ``randn`` a slice of its leading axis
    instead, slice 0 first (a slice still past it is sliced again), at the
    leaf's std: the fan-in rule sees the whole leaf.  No leaf of a dense
    config at the depths the port has drawn them reaches it (the largest,
    deepseek-7b's uncut stacked ``wi``, is 5.4 GB), so those weights are
    the single draws of before.  The numbers differ from ``jax.random``'s:
    tests that compare with the reference carry its parameters across
    instead (``repro_torch.convert.lm_params_from_reference``)."""
    dev = resolve_device(device)

    def build(tree):
        if is_spec(tree):
            return _init_one(tree, generator, dev)
        return {k: build(tree[k]) for k in sorted(tree)}

    return build(spec_tree)


def abstract_params(spec_tree):
    """A spec tree as a tree of ``meta`` tensors of the same shapes and
    dtypes (the reference's ``ShapeDtypeStruct`` tree): nothing is allocated
    and nothing is drawn.  ``meta`` is for counting only (the dry run, the
    cost counter): no model runs there, and :func:`init_params` still
    refuses any device but ``cuda`` and ``cpu``."""
    if is_spec(spec_tree):
        return torch.empty(spec_tree.shape, dtype=spec_tree.dtype, device="meta")
    return {k: abstract_params(spec_tree[k]) for k in sorted(spec_tree)}
