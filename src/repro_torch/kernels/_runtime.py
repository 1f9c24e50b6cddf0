"""What every kernel wrapper of the port shares: launch counts, input
checks, the CPU/CUDA route and the ctypes launch.

A wrapper checks device, dtype, shape and contiguity, runs its kernel's
plain version (``kernels/ref.py``) on CPU tensors, and on CUDA tensors
launches the kernel — or raises, never falling back.  Each launch adds one
to its kernel's count in :data:`LAUNCHES`; the plain route counts nothing
there.  :data:`DISPATCHES` counts on both routes (the counterpart of the
reference's ``count_dispatches``, which counts at trace time on any
backend): a launch adds one, and the plain route adds the launches the
CUDA route would have made for the same call (:func:`plain`), so after any
call on the card ``DISPATCHES == LAUNCHES``, and on the CPU a plan's
dispatch structure is countable all the same.
"""
from __future__ import annotations

import ctypes

import torch

#: launches per kernel since the last :func:`reset_launch_counts`
LAUNCHES = {
    "fused_round_step/scalar": 0,
    "fused_round_step/group": 0,
    "fused_round_step/bundle": 0,
    "fused_prefix_states": 0,
    "group_agg": 0,
    "shard_chunk_partials": 0,
    "chunk_agg": 0,
    "q6_agg": 0,
    "decode": 0,
}

#: dispatches per kernel, on either route, since the last
#: :func:`reset_launch_counts`
DISPATCHES = dict.fromkeys(LAUNCHES, 0)

F32, I32 = torch.float32, torch.int32

#: rows one block of the group step sorts in shared memory
#: (``csrc/agg_common.cuh``): L for K1 group and bundle, block_rows for K3
MAX_GROUP_ROWS = 4096


def reset_launch_counts() -> None:
    """Zero :data:`LAUNCHES` and :data:`DISPATCHES`."""
    for k in LAUNCHES:
        LAUNCHES[k] = DISPATCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def dispatch_counts() -> dict:
    return dict(DISPATCHES)


def plain(count: str, n: int = 1) -> None:
    """Count ``n`` dispatches of ``count`` taken by the plain route: the
    launches the CUDA route makes for the same call."""
    DISPATCHES[count] += n


def check(name, t, dtype, shape, device) -> None:
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


def route(device: torch.device) -> str:
    """"plain" for a CPU tensor, "cuda" for a CUDA tensor; raises else."""
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for device {device}")


def launch(lib: ctypes.CDLL, fn, *args, device: torch.device, count: str) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream; raise with
    CUDA's message when it reports an error, else count the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = lib.pf_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} (error {err})")
    LAUNCHES[count] += 1
    DISPATCHES[count] += 1


def ptr(t):
    """A tensor's device address for ctypes (``None`` passes a null)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def bind(lib: ctypes.CDLL, **signatures) -> ctypes.CDLL:
    """Declare each ``name=(n_pointers, n_ints)`` entry (pointers first,
    then ints, then the stream) once per library."""
    if not getattr(lib, "_pf_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, (n_ptr, n_int) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
            fn.restype = i
        lib.pf_error_string.argtypes = [i]
        lib.pf_error_string.restype = ctypes.c_char_p
        lib._pf_bound = True
    return lib
