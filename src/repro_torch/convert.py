"""Carry data and states across from the JAX package's numpy layout.

The parity tests build shards once with the reference's generator and
randomizer and hand the same arrays to both packages; these helpers turn
them into the port's tensors.  They take numpy-convertible arrays (a JAX
array converts through ``np.asarray`` without this module importing JAX).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.estimators import MultState, SumState
from repro_torch.uda import tree_map


def _tensor(x, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dev)  # np.array: writable copy


def shards_from_reference(np_shards: dict, device="cuda") -> dict:
    """Packed ``[P, C, L]`` shards (numpy or JAX arrays) -> tensors on
    ``device``, dtypes kept (int32 columns stay int32, ``_mask`` float32)."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in np_shards.items()}


def state_from_reference(state, device="cuda") -> SumState:
    """A reference ``SumState`` (any leaf shapes) -> the port's ``SumState``."""
    dev = resolve_device(device)
    return SumState(*(_tensor(getattr(state, f), dev) for f in SumState._fields))


def mult_state_from_reference(state, device="cuda") -> MultState:
    """A reference ``MultState`` (numpy or JAX leaves) -> the port's."""
    dev = resolve_device(device)
    return MultState(state_from_reference(state.base, dev),
                     _tensor(state.est, dev), _tensor(state.estvar, dev))


def _param_tensor(x, dev: torch.device) -> torch.Tensor:
    """A numpy (or JAX) array -> a tensor of the same dtype on ``dev``;
    bfloat16 (``ml_dtypes``' numpy type, which torch does not read) goes
    across as its 16-bit words."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
    return _tensor(a, dev)


def _param_tree(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _param_tree(v, dev) for k, v in tree.items()}
    return _param_tensor(tree, dev)


def lm_params_from_reference(np_params, cfg, device="cuda"):
    """The reference's LM parameter tree (``repro.models.transformer``'s
    ``param_specs`` layout, leaves numpy or JAX arrays) -> the port's
    ``Transformer`` over the same tree (stacked ``layers/b{i}/*`` leaves
    included), dtypes kept, parameters frozen."""
    from repro_torch.models.transformer import Transformer

    return Transformer(cfg, _param_tree(np_params, resolve_device(device)))


def lm_train_state_from_reference(np_params, np_opt, cfg, device="cuda"):
    """The reference's parameters and optimizer state (an ``AdamWState`` or
    ``AdafactorState`` of ``repro.training.optimizer``, leaves numpy or JAX
    arrays) -> (a trainable ``Transformer``, the port's state of the same
    kind), so that both packages train from the same point."""
    from repro_torch.training import optimizer as O

    dev = resolve_device(device)
    model = lm_params_from_reference(np_params, cfg, dev).requires_grad_(True)
    kind = O.AdamWState if hasattr(np_opt, "master") else O.AdafactorState
    step = torch.as_tensor(int(np.asarray(np_opt.step)), dtype=torch.int32, device=dev)
    return model, kind(step, *(_param_tree(getattr(np_opt, f), dev) for f in kind._fields[1:]))


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor -> numpy; bf16 as float32 (exact)."""
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_to_numpy(model):
    """A ``Transformer``'s parameters -> the reference's stacked tree of
    numpy arrays (bf16 leaves as float32, exact)."""
    return tree_map(_host, model.params)


def lm_cache_to_numpy(cache, cfg):
    """The port's per-layer cache list -> the reference's cache tree
    (``{"layers": {"b{i}": leaves stacked over the groups}, "tail":
    {"t{i}": ...}}``) of numpy arrays; bf16 leaves come back as float32
    (exact), the others in their dtype."""
    pat = len(cfg.block_pattern)
    n_groups = cfg.num_layers // pat

    def stack(layers):
        return {k: np.stack([_host(c[k]) for c in layers]) for k in layers[0]}

    return {"layers": {f"b{j}": stack(cache[j:n_groups * pat:pat]) for j in range(pat)}
            if n_groups else {},
            "tail": {f"t{i}": {k: _host(v) for k, v in c.items()}
                     for i, c in enumerate(cache[n_groups * pat:])}}


def state_to_numpy(state):
    """A port state (any tree of tensors) -> the same tree of numpy arrays,
    the form the reference's states take through ``np.asarray``."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)
