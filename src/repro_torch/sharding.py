"""Sharding rule table: logical parameter axes -> mesh axes.

Port of ``repro/dist/sharding.py``, rule for rule.  Every parameter
declares *logical* axis names in its ``ParamSpec``
(``repro_torch.models.spec``); this module is the one place where logical
names meet a mesh.  Rules:

  * exactly one dimension shards on ``model``, chosen by priority
    (:data:`MODEL_PRIORITY`: experts > vocab > mlp > heads > kv > state >
    embed) among dimensions divisible by the axis size; an indivisible
    candidate falls through to the next name, and if nothing divides, the
    parameter replicates (smollm's 9 heads fall back to sharding embed,
    grok's 8 experts to d_ff);
  * with ``opt_data_axis`` set (ZeRO / FSDP), one *more* dimension shards on
    the data axis: the first remaining logical dimension that divides, never
    ``layers`` (the stacked layer axis stays whole on every device);
  * decode caches shard batch over the data axes and the sequence over
    ``model`` (flash-decoding), by :func:`cache_pspecs`.

A leaf's placement is a tuple with one entry per dimension: a mesh-axis
name, a tuple of names (batch over ``("pod", "data")``), or ``None`` — the
reference's ``PartitionSpec`` as a plain tuple.  :func:`to_placements`
turns one into ``torch.distributed.tensor`` placements on a
``DeviceMesh``.  The table is pure shape arithmetic: it reads only
``mesh.mesh_dim_names`` and ``mesh.shape``, so a ``DeviceMesh`` or any
stand-in with those two fields will do, and it never touches a device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.spec import is_spec
from repro_torch.uda import tree_map

# Priority for the single model-parallel dimension.  "layers" is absent by
# design: the stacked layer axis is never sharded.
MODEL_PRIORITY: Tuple[str, ...] = (
    "experts", "vocab", "mlp", "heads", "kv", "state", "embed")


def mesh_axis_size(mesh, axis: str) -> int:
    """Size of a named mesh axis (1 if the mesh does not have it)."""
    names = tuple(mesh.mesh_dim_names)
    if axis not in names:
        return 1
    return int(tuple(mesh.shape)[names.index(axis)])


def ambient_mesh():
    """The mesh activations should be pinned against: always ``None``.

    The reference reads the mesh ``jax.set_mesh`` installed, and its model
    code pins activations against it (``pin_batch_activation``,
    ``_pin_replicated_heads``, the MoE expert constraint).  The port
    executes a model on one card only — the rule table places parameters
    for the dry run, not for a run across cards — so no mesh is ambient and
    those helpers stay out of ``models/``."""
    return None


def batch_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes, outermost first (``pod`` crosses nodes)."""
    return tuple(a for a in ("pod", "data") if a in tuple(mesh.mesh_dim_names))


def spec_pspec(spec, mesh, *, opt_data_axis: Optional[str] = None,
               model_axis: str = "model") -> tuple:
    """Placement of one parameter (a ``ParamSpec``) under the rule table."""
    assign = [None] * len(spec.shape)
    msize = mesh_axis_size(mesh, model_axis)
    if msize > 1:
        for name in MODEL_PRIORITY:
            hit = [i for i, lg in enumerate(spec.logical)
                   if lg == name and spec.shape[i] % msize == 0 and spec.shape[i] >= msize]
            if hit:
                assign[hit[0]] = model_axis
                break
    if opt_data_axis is not None:
        dsize = mesh_axis_size(mesh, opt_data_axis)
        if dsize > 1:
            for i, lg in enumerate(spec.logical):
                if (lg is not None and lg != "layers" and assign[i] is None
                        and spec.shape[i] % dsize == 0 and spec.shape[i] >= dsize):
                    assign[i] = opt_data_axis
                    break
    return tuple(assign)


def _spec_map(fn, tree):
    if is_spec(tree):
        return fn(tree)
    return {k: _spec_map(fn, tree[k]) for k in sorted(tree)}


def param_pspecs(spec_tree, mesh, *, opt_data_axis: Optional[str] = None):
    """Placement tree for a ``ParamSpec`` tree (same keys)."""
    return _spec_map(lambda s: spec_pspec(s, mesh, opt_data_axis=opt_data_axis), spec_tree)


def cache_pspecs(cache_abs, mesh, *, batch: int, seq_len: int, model_axis: str = "model"):
    """Decode-cache placements: batch over the data axes, the sequence over
    ``model`` (flash-decoding).  Dimensions are recognized by size — cache
    layouts vary per architecture, but the batch and sequence extents are
    unambiguous.  ``cache_abs`` is any tree of tensors (the port's list of
    per-layer dicts, e.g. ``transformer.abstract_cache``)."""
    daxes = batch_axes(mesh)
    dsize = math.prod(mesh_axis_size(mesh, a) for a in daxes)
    dspec = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    msize = mesh_axis_size(mesh, model_axis)

    def one(x):
        assign = [None] * len(x.shape)
        for i, d in enumerate(x.shape):
            if d == batch and dsize > 1 and d % dsize == 0:
                assign[i] = dspec
                break
        for i, d in enumerate(x.shape):
            if assign[i] is None and d == seq_len and msize > 1 and d % msize == 0:
                assign[i] = model_axis
                break
        return tuple(assign)

    return tree_map(one, cache_abs)


def placement_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one dimension's placement entry names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_count(pspec, mesh) -> int:
    """Devices one leaf's placement splits it over."""
    return math.prod(mesh_axis_size(mesh, a) for e in pspec for a in placement_axes(e))


def per_device_shape(shape, pspec, mesh) -> Tuple[int, ...]:
    """One device's block of a leaf of ``shape`` under ``pspec`` (each
    sharded extent divided by the product of its axes' sizes; the rule
    table only places an axis where it divides)."""
    return tuple(d // math.prod(mesh_axis_size(mesh, a) for a in placement_axes(e))
                 for d, e in zip(shape, pspec))


def leaf_placements(tree, pspecs):
    """``(leaf, placement)`` pairs of a tree of tensors or ``ParamSpec``s
    (dicts, lists, tuples and NamedTuples of them) and its placement tree of
    the same structure, in the tree's order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in leaf_placements(tree[k], pspecs[k])]
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(pspecs):
            raise ValueError(f"a node of {len(tree)} entries but {len(pspecs)} placements")
        return [p for t, s in zip(tree, pspecs) for p in leaf_placements(t, s)]
    if tree is None:
        return []
    return [(tree, tuple(pspecs))]


def per_device_bytes(tree, pspecs, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, ``meta`` ones included,
    or ``ParamSpec``s) under the placement tree ``pspecs``: for each leaf
    ``numel × itemsize`` over the sizes of the axes it shards on."""
    total = 0
    for x, ps in leaf_placements(tree, pspecs):
        if len(ps) != len(x.shape):
            raise ValueError(f"placement {ps} does not fit a leaf of shape {tuple(x.shape)}")
        itemsize = torch.empty((), dtype=x.dtype, device="meta").element_size()
        total += math.prod(per_device_shape(tuple(x.shape), ps, mesh)) * itemsize
    return total


def to_placements(pspec, mesh) -> list:
    """A leaf's placement -> ``torch.distributed.tensor`` placements, one a
    mesh dimension: ``Shard(i)`` where tensor dimension ``i`` names that
    mesh axis (alone or in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(pspec) if name in placement_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
