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


class FusedSpec(NamedTuple):
    """Contract of the fused selection→bucket→aggregate kernel
    (``repro_torch.kernels.fused_agg``).

      func:  chunk -> [..., L] or [..., L, num_aggs] values
      cond:  chunk -> [..., L] 0/1 predicate (bare — the wrapper fuses
             ``_mask``)
      group: chunk -> [..., L] int dense group ids in [0, num_groups),
             already hash-bucketed; None selects the scalar SumState contract
      num_aggs, num_groups: A and G (None for scalar)

    The closures are PyTorch code: the kernel wrapper evaluates them on the
    round-slice on the device and hands (vals, weight, gids) to the CUDA
    kernel, which does the chunk-ordered carry-in accumulation.
    """

    func: Callable[[Chunk], Any]
    cond: Callable[[Chunk], Any]
    group: Optional[Callable[[Chunk], Any]]
    num_aggs: int
    num_groups: Optional[int] = None


def _identity(state: State, ctx: Optional[dict] = None) -> State:
    """Default EstimatorTerminate: the state is its own partial aggregate."""
    return state


@dataclasses.dataclass(frozen=True)
class GLA:
    """An associative-decomposable UDA with the extended (estimation) interface.

    ``init`` takes the device the state lives on.  ``merge_is_additive``
    lets the engine merge partitions as a weighted sum.  ``fused`` publishes
    the fused-kernel contract that ``emit="kernel"`` runs.
    """

    init: Callable[[Any], State]
    accumulate: Callable[[State, Chunk], State]
    merge: Callable[[State, State], State]
    terminate: Callable[[State], Any]
    estimator_terminate: Callable[[State, Optional[dict]], State] = _identity
    estimator_merge: Optional[Callable[[State, State], State]] = None
    estimate: Optional[Callable[..., Estimate]] = None
    merge_is_additive: bool = False
    fused: Optional[FusedSpec] = None
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


def tree_stack(trees, dim: int = 0):
    """Stack a list of same-structured states along a new axis ``dim``."""
    return tree_map(lambda *xs: torch.stack(xs, dim), *trees)
