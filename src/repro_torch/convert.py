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


def state_to_numpy(state):
    """A port state (any tree of tensors) -> the same tree of numpy arrays,
    the form the reference's states take through ``np.asarray``."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)
