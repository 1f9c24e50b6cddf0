"""Extended UDA (User-Defined Aggregate) interface — paper Table 1.

Port of ``repro/core/uda.py``.  A GLA is an associative-decomposable UDA:
a bundle of functions over a state whose leaves are tensors.  The engine
(``repro_torch.engine``) owns every parallel-execution detail.

    Init                -> GLA.init(device)
    Accumulate(Item d)  -> GLA.accumulate(state, chunk)    [chunk-vectorized]
    Merge(in1,in2,out)  -> GLA.merge(s1, s2) -> s
    Terminate           -> GLA.terminate(state)
    EstimatorTerminate  -> GLA.estimator_terminate(state, ctx)
    EstimatorMerge      -> GLA.estimator_merge(s1, s2)
    Estimate            -> GLA.estimate(state, confidence) -> Estimate

Where JAX ``vmap``s a GLA over partitions, the port writes the batch axis
out: ``accumulate`` takes chunk columns shaped ``[B, L]`` and states whose
leaves carry the same leading ``B``; ``estimate`` takes states with any
leading axes (rounds, partitions) and broadcasts over them.  Every chunk
carries a ``_mask`` column (1 = live item); masked items never contribute.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

Chunk = dict  # column name -> [..., L] tensor; always includes "_mask"
State = Any


class Estimate(NamedTuple):
    """Result of GLA.estimate — estimator with confidence bounds."""

    estimate: Any
    lower: Any
    upper: Any
    info: Any = None


class ProbeTable:
    """A dimension-side array a join's fused closures read by key.

    The reference threads such arrays into its Pallas kernel as explicit
    operands and injects them into the in-kernel column dict under
    ``key``; here :func:`repro_torch.kernels.fused_agg.project` puts
    ``values`` into the column dict under ``key`` before the closures run,
    so the fused closures gather from ``chunk[pt.key]`` exactly as the scan
    path gathers from the closed-over tensor.  Identity semantics: equal
    only to itself, hashed by identity (tensors are unhashable).
    """

    _ids = 0

    def __init__(self, name: str, values: torch.Tensor):
        ProbeTable._ids += 1
        self.name = name
        self.values = values
        self.key = f"__probe{ProbeTable._ids}_{name}"

    @property
    def nbytes(self) -> int:
        return self.values.numel() * self.values.element_size()

    def __repr__(self):
        v = self.values
        return f"ProbeTable({self.name}, shape={tuple(v.shape)}, {v.dtype})"


class FusedSpec(NamedTuple):
    """Contract of the fused selection→bucket→aggregate kernel
    (``repro_torch.kernels.fused_agg``).

      func:  chunk -> [..., L] or [..., L, num_aggs] values
      cond:  chunk -> [..., L] 0/1 predicate (bare — the wrapper fuses
             ``_mask``)
      group: chunk -> [..., L] int dense group ids in [0, num_groups),
             already hash-bucketed; None selects the scalar SumState contract
      num_aggs, num_groups: A and G (None for scalar)
      probe_tables: :class:`ProbeTable` s the closures read via
             ``chunk[pt.key]``; their combined bytes decide, by the
             reference's routing rule, whether the fused kernel runs
             (``fused_agg.fused_available``).

    The closures are PyTorch code: the kernel wrapper evaluates them on the
    round-slice on the device and hands (vals, weight, gids) to the CUDA
    kernel, which does the chunk-ordered carry-in accumulation.
    """

    func: Callable[[Chunk], Any]
    cond: Callable[[Chunk], Any]
    group: Optional[Callable[[Chunk], Any]]
    num_aggs: int
    num_groups: Optional[int] = None
    probe_tables: tuple = ()


def _identity(state: State, ctx: Optional[dict] = None) -> State:
    """Default EstimatorTerminate: the state is its own partial aggregate."""
    return state


@dataclasses.dataclass(frozen=True)
class GLA:
    """An associative-decomposable UDA with the extended (estimation) interface.

    ``init`` takes the device the state lives on.  ``merge_is_additive``
    lets the engine merge partitions as a weighted sum.  ``fused`` publishes
    the fused-kernel contract that ``emit="kernel"`` runs.

    ``kernel_cols`` is the legacy projection that ``emit="kernel"`` falls
    back to when no usable fused contract exists (a join over the probe
    budget, a GLA built with ``fused=None``).  Two contracts, selected by
    ``kernel_num_groups``: scalar, ``chunk -> (vals, weight)``, served by
    K4 (``kernels.ops.shard_chunk_partials``) once per shard; group-by,
    ``chunk -> (vals, weight, gids)`` with ``kernel_num_groups`` the dense
    table size G, served by K3 (``kernels.ops.group_agg``) once per
    round-slice.  ``weight`` is the bare predicate; the engine fuses
    ``_mask``.  ``members`` is non-empty only for a bundle
    (``repro_torch.gla.GLABundle``): the GLAs whose states it stacks.
    """

    init: Callable[[Any], State]
    accumulate: Callable[[State, Chunk], State]
    merge: Callable[[State, State], State]
    terminate: Callable[[State], Any]
    estimator_terminate: Callable[[State, Optional[dict]], State] = _identity
    estimator_merge: Optional[Callable[[State, State], State]] = None
    estimate: Optional[Callable[..., Estimate]] = None
    merge_is_additive: bool = False
    kernel_cols: Optional[Callable[[Chunk], Any]] = None
    kernel_num_groups: Optional[int] = None
    fused: Optional[FusedSpec] = None
    members: tuple = ()
    name: str = "gla"

    def __post_init__(self):
        if self.estimator_merge is None:
            object.__setattr__(self, "estimator_merge", self.merge)

    def with_(self, **kw) -> "GLA":
        return dataclasses.replace(self, **kw)


def masked(cond: Any, chunk: Chunk) -> Any:
    """Combine a selection predicate with the chunk liveness mask."""
    return cond * chunk["_mask"]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over states built from tuples (NamedTuples
    included), lists and dicts — the port's ``jax.tree.map``.  ``None``
    leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(type(tree), "_fields") else tuple(out)
    if isinstance(tree, list):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a state in :func:`tree_map`'s order (dicts in key
    insertion order) — the port's ``jax.tree.leaves``."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_stack(trees, dim: int = 0):
    """Stack a list of same-structured states along a new axis ``dim``."""
    return tree_map(lambda *xs: torch.stack(xs, dim), *trees)
