"""Fused selection→aggregate kernels on Hopper — port of
``repro/kernels/fused_agg.py``.

Two kernels carry the main path's device work (``csrc/fused_agg.cu``):

  K1 ``fused_round_step``    advance a carried SumState over one round-slice
                             (scalar: ``pf_scalar`` with a carry; group:
                             ``pf_group``).  Serves every ``kernel_fused``
                             session step and the engine's group path.
  K2 ``fused_prefix_states`` the running state after every chunk of a whole
                             shard (``pf_scalar`` with prefix output).  Serves
                             the engine's scalar ``emit="kernel"`` path.

The TPU kernels run the ``FusedSpec`` closures inside their body.  Here the
closures stay PyTorch: :func:`project` evaluates them on the round-slice on
the device and the CUDA kernels do the chunk-ordered, carry-in
accumulation.  The partition axis is a batch axis of one launch.

The tensor-level wrappers (:func:`scalar_round_step`, :func:`scalar_prefix`,
:func:`group_round_step`) check device, dtype, shape and contiguity, run the
plain version (``kernels/ref.py``) on CPU tensors, and on CUDA tensors launch
the kernel — or raise, never falling back.  Each launch adds one to its
kernel's count in :data:`LAUNCHES` (the counterpart of the reference's
``count_dispatches``).  ``scanned`` is summed outside the kernels, as in the
reference: live counts are integers and need only ``_mask``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import estimators as E
from repro_torch.kernels import _build, ref

#: launches per kernel since the last :func:`reset_launch_counts`
LAUNCHES = {
    "fused_round_step/scalar": 0,
    "fused_round_step/group": 0,
    "fused_prefix_states": 0,
}

MAX_GROUP_ROWS = 4096  # L bound of the group kernel's shared-memory sort

_F32, _I32 = torch.float32, torch.int32


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_agg")
    if not getattr(lib, "_pf_bound", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.pf_scalar.argtypes = [ptr] * 6 + [i] * 4 + [ptr]
        lib.pf_scalar.restype = i
        lib.pf_group.argtypes = [ptr] * 9 + [i] * 5 + [ptr]
        lib.pf_group.restype = i
        lib.pf_error_string.argtypes = [i]
        lib.pf_error_string.restype = ctypes.c_char_p
        lib._pf_bound = True
    return lib


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(device: torch.device) -> str:
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for device {device}")


def _launch(fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = _lib().pf_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} (error {err})")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _scalar(vals, w, carry, prefix: bool):
    P, C, L, A = vals.shape
    dev = vals.device
    _check("w", w, _F32, (P, C, L), dev)
    if carry is not None:
        _check("carry", carry, _F32, (P, 2 * A + 1), dev)
    if _route(dev) == "plain":
        return (ref.scalar_prefix(vals, w) if prefix
                else ref.scalar_round_step(vals, w, carry))
    part = torch.empty((P, C, 2 * A + 1), dtype=_F32, device=dev)
    out = torch.empty((P, 2 * A + 1), dtype=_F32, device=dev)
    pre = torch.empty_like(part) if prefix else None
    _launch(_lib().pf_scalar, _ptr(vals), _ptr(w), _ptr(part),
            None if carry is None else _ptr(carry), _ptr(out),
            None if pre is None else _ptr(pre), P, C, L, A, device=dev)
    LAUNCHES["fused_prefix_states" if prefix else "fused_round_step/scalar"] += 1
    return pre if prefix else out


def _check_vals(vals):
    if not isinstance(vals, torch.Tensor) or vals.ndim != 4:
        raise ValueError("vals must be a [P, C, L, A] tensor")
    _check("vals", vals, _F32, vals.shape, vals.device)
    if min(vals.shape[0], vals.shape[3]) < 1:
        raise ValueError("vals needs P >= 1 and A >= 1")


def scalar_round_step(vals: torch.Tensor, w: torch.Tensor,
                      carry: torch.Tensor) -> torch.Tensor:
    """K1, scalar: carry [P, 2A+1] = (sum | sumsq | matched) advanced over
    the C chunks of ``vals [P, C, L, A]`` / ``w [P, C, L]`` in chunk order."""
    _check_vals(vals)
    return _scalar(vals, w, carry, prefix=False)


def scalar_prefix(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K2: running (sum | sumsq | matched) after every chunk, [P, C, 2A+1]."""
    _check_vals(vals)
    return _scalar(vals, w, None, prefix=True)


def group_round_step(vals, w, gids, carry_s, carry_q, carry_m):
    """K1, group: per-group sums over ``gids [P, C, L]`` added onto the
    carries ``[P, G, A]``, ``[P, G, A]``, ``[P, G]`` chunk by chunk."""
    _check_vals(vals)
    P, C, L, A = vals.shape
    dev = vals.device
    G = carry_m.shape[-1] if carry_m.ndim == 2 else -1
    _check("w", w, _F32, (P, C, L), dev)
    _check("gids", gids, _I32, (P, C, L), dev)
    _check("carry_s", carry_s, _F32, (P, G, A), dev)
    _check("carry_q", carry_q, _F32, (P, G, A), dev)
    _check("carry_m", carry_m, _F32, (P, G), dev)
    if _route(dev) == "plain":
        return ref.group_round_step(vals, w, gids, carry_s, carry_q, carry_m)
    if L > MAX_GROUP_ROWS:
        raise ValueError(f"group kernel sorts a chunk in shared memory: "
                         f"L={L} exceeds {MAX_GROUP_ROWS}")
    out_s, out_q = torch.empty_like(carry_s), torch.empty_like(carry_q)
    out_m = torch.empty_like(carry_m)
    _launch(_lib().pf_group, _ptr(vals), _ptr(w), _ptr(gids), _ptr(carry_s),
            _ptr(carry_q), _ptr(carry_m), _ptr(out_s), _ptr(out_q),
            _ptr(out_m), P, C, L, A, G, device=dev)
    LAUNCHES["fused_round_step/group"] += 1
    return out_s, out_q, out_m


# ---------------------------------------------------------------------------
# GLA-level entry points
# ---------------------------------------------------------------------------

def fused_available(gla) -> bool:
    """True when ``gla`` publishes the fused kernel contract."""
    return gla.fused is not None


def project(fs, cols):
    """Evaluate the FusedSpec closures on ``cols`` ({name: [P, C, L]}):
    (vals [P, C, L, A] f32, w = cond·_mask [P, C, L] f32, gids i32 or None),
    contiguous, on the columns' device."""
    mask = cols["_mask"]
    vals = fs.func(cols)
    if vals.ndim == mask.ndim:
        vals = vals.unsqueeze(-1)
    vals = vals.to(_F32).contiguous()
    w = (fs.cond(cols) * mask).to(_F32).contiguous()
    gids = None if fs.group is None else fs.group(cols).to(_I32).contiguous()
    return vals, w, gids


def _live_counts(mask: torch.Tensor) -> torch.Tensor:
    """Live rows per (partition, chunk), [P, C] float64 — exact integers."""
    return mask.sum(dim=-1, dtype=torch.float64)


def _fused_spec(gla):
    fs = gla.fused
    if fs is None:
        raise ValueError(f"GLA {gla.name!r} does not publish a fused kernel contract")
    return fs


def fused_round_step(gla, state: E.SumState, cols: dict) -> E.SumState:
    """K1: advance the per-partition ``state`` (leaves [P, ...]) over one
    round-slice ``cols`` ({name: [P, C, L]}, incl. ``_mask``)."""
    fs = _fused_spec(gla)
    vals, w, gids = project(fs, cols)
    A = vals.shape[-1]
    scanned = state.scanned + _live_counts(cols["_mask"]).sum(dim=1).to(_F32)
    if gids is None:
        carry = torch.cat([state.sum, state.sumsq, state.matched[:, None]],
                          dim=1).contiguous()
        out = scalar_round_step(vals, w, carry)
        return E.SumState(sum=out[:, :A], sumsq=out[:, A:2 * A],
                          scanned=scanned, matched=out[:, 2 * A])
    s, q, m = group_round_step(vals, w, gids, state.sum.contiguous(),
                               state.sumsq.contiguous(),
                               state.matched.contiguous())
    return E.SumState(sum=s, sumsq=q, scanned=scanned, matched=m)


def fused_prefix_states(gla, cols: dict):
    """K2: whole-shard scalar scan of ``cols`` ({name: [P, C, L]}) emitting
    per-chunk prefixes.  Returns ``(final, prefixes)``: leaves [P, ...] and
    [P, C + 1, ...] (row 0 is init(), row c+1 the state after chunk c)."""
    fs = _fused_spec(gla)
    if fs.group is not None:
        raise ValueError(f"fused_prefix_states needs a scalar GLA, got {gla.name!r}")
    vals, w, _ = project(fs, cols)
    P, _, _, A = vals.shape
    pre = scalar_prefix(vals, w)
    zero = torch.zeros((P, 1, 2 * A + 1), dtype=_F32, device=pre.device)
    pre = torch.cat([zero, pre], dim=1)  # [P, C+1, 2A+1]
    counts = _live_counts(cols["_mask"])
    scanned = torch.cat([torch.zeros_like(counts[:, :1]), counts.cumsum(dim=1)],
                        dim=1).to(_F32)
    prefixes = E.SumState(sum=pre[..., :A], sumsq=pre[..., A:2 * A],
                          scanned=scanned, matched=pre[..., 2 * A])
    final = E.SumState(*(x[:, -1] for x in prefixes))
    return final, prefixes
