"""Serialize / Deserialize — the paper's UDA transfer extension, for
checkpoints of sessions (``Session.pause`` / ``Session.resume``) and of
training (:func:`save_train_state` / :func:`load_train_state`).

Port of ``repro/checkpoint/ckpt.py:52-145`` in a format of its own: the
reference's msgpack envelope needs ``msgpack`` (and optionally
``zstandard``), which the port does not depend on.  Standard library and
NumPy only.

An *envelope* file is ``MAGIC``, the byte length of a JSON header as 8
little-endian bytes, the header — ``{"framework": "repro_torch", "meta":
meta}``, readable without the blob — and the state *blob*. A blob
(:func:`write_state`) is one zlib stream: an 8-byte header length, a
JSON table (the state's structure and each leaf's dtype name, shape and
byte range) and every leaf's little-endian raw bytes (a bfloat16 leaf's
16-bit words), so states come back bit for bit, ±inf included.  It is
written and read one leaf at a time, so a training state of many GB never
sits whole in host memory.  Writes are atomic (a temporary file, then
``replace``).  A file that does not start with ``MAGIC`` — the
reference's msgpack envelope, say — is refused as foreign with a
``ValueError``.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from pathlib import Path
from typing import Any, BinaryIO, Callable, Tuple

import numpy as np
import torch

from repro_torch.uda import tree_leaves, tree_map

FRAMEWORK = "repro_torch"
MAGIC = b"REPRO_TORCH_CKPT\x00"
_LEN = struct.Struct("<Q")
_CHUNK = 1 << 26  # bytes read or inflated at a time


def treedef(tree) -> str:
    """The structure of a state: containers, NamedTuple names and field
    names, dict keys; ``*`` for a tensor leaf, ``None`` for an empty one."""
    if tree is None:
        return "None"
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        inner = ",".join(f"{f}={treedef(v)}" for f, v in zip(tree._fields, tree))
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, tuple):
        return "(" + ",".join(treedef(v) for v in tree) + ")"
    if isinstance(tree, list):
        return "[" + ",".join(treedef(v) for v in tree) + "]"
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{treedef(v)}" for k, v in tree.items()) + "}"
    return "*"


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A leaf's little-endian bytes on the host, as uint8 (a bfloat16
    leaf's 16-bit words)."""
    t = t.detach().cpu().contiguous()
    a = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return a.astype(a.dtype.newbyteorder("<"), copy=False).reshape(-1).view(np.uint8)


def write_state(f: BinaryIO, state: Any, level: int = 6) -> None:
    """Write a state (tensors in tuples, NamedTuples, lists and dicts) to
    the binary file ``f`` as a blob, zlib-compressed at ``level`` (0:
    stored, for weights that do not compress), one leaf at a time: the
    host holds one leaf's bytes at once, not the state's."""
    leaves = tree_leaves(state)
    table, off = [], 0
    for t in leaves:
        n = t.numel() * t.element_size()
        name = "bfloat16" if t.dtype == torch.bfloat16 else torch.empty(0, dtype=t.dtype).numpy().dtype.name
        table.append({"dtype": name, "shape": list(t.shape), "offset": off, "nbytes": n})
        off += n
    head = json.dumps({"treedef": treedef(state), "leaves": table}).encode()
    z = zlib.compressobj(level)
    f.write(z.compress(_LEN.pack(len(head)) + head))
    for t in leaves:
        f.write(z.compress(_host_bytes(t)))
    f.write(z.flush())


def serialize_state(state: Any, level: int = 6) -> bytes:
    """:func:`write_state`'s blob as bytes."""
    buf = io.BytesIO()
    write_state(buf, state, level)
    return buf.getvalue()


class _Inflater:
    """The inflated bytes of a zlib stream read from a binary file, handed
    out in order, at most _CHUNK of them inflated at a time."""

    def __init__(self, f: BinaryIO):
        self.f, self.z = f, zlib.decompressobj()
        self.out, self.pos = memoryview(b""), 0

    def into(self, dst: memoryview) -> None:
        """Fill ``dst`` (bytes) with the next inflated bytes."""
        i = 0
        while i < len(dst):
            if self.pos == len(self.out):
                src = self.z.unconsumed_tail or self.f.read(_CHUNK)
                if not src:
                    raise ValueError("checkpoint state blob ends early")
                self.out, self.pos = memoryview(self.z.decompress(src, _CHUNK)), 0
            k = min(len(self.out) - self.pos, len(dst) - i)
            dst[i:i + k] = self.out[self.pos:self.pos + k]
            i, self.pos = i + k, self.pos + k

    def take(self, n: int) -> bytes:
        buf = bytearray(n)
        self.into(memoryview(buf))
        return bytes(buf)


def read_state(f: BinaryIO, like: Any, device="cpu") -> Any:
    """A blob of :func:`write_state`, read from the binary file ``f`` one
    leaf at a time -> the state, its leaves on ``device``.  ``like`` gives
    the structure (a skeleton built from the configuration; its leaves'
    values are not read); a blob of another structure is a
    ``ValueError``."""
    inf = _Inflater(f)
    (n,) = _LEN.unpack(inf.take(_LEN.size))
    head = json.loads(inf.take(n))
    want = treedef(like)
    if head["treedef"] != want:
        raise ValueError(
            f"checkpoint state structure {head['treedef']!r} does not match "
            f"this session's {want!r}")
    leaves, off = [], 0
    for rec in head["leaves"]:
        if rec["offset"] != off:
            raise ValueError(f"checkpoint leaf at byte {rec['offset']}, expected {off}")
        off += rec["nbytes"]
        bf16 = rec["dtype"] == "bfloat16"
        a = np.empty(rec["shape"], dtype=np.dtype(np.int16 if bf16 else rec["dtype"]).newbyteorder("<"))
        inf.into(memoryview(a.reshape(-1).view(np.uint8)))
        t = torch.from_numpy(a.astype(a.dtype.newbyteorder("="), copy=False))
        leaves.append((t.view(torch.bfloat16) if bf16 else t).to(device))
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def deserialize_state(buf: bytes, like: Any, device="cpu") -> Any:
    """Bytes from :func:`serialize_state` -> the state (:func:`read_state`)."""
    return read_state(io.BytesIO(buf), like, device)


def _write_envelope(path, meta: dict, write: Callable[[BinaryIO], None]) -> None:
    """Atomically write the header of ``meta``, then whatever ``write``
    writes to the file."""
    head = json.dumps({"framework": FRAMEWORK, "meta": meta}).encode()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC + _LEN.pack(len(head)) + head)
        write(f)
    tmp.replace(path)


def save_envelope(path, meta: dict, blob: bytes) -> None:
    """Atomically write a (JSON meta header, state blob) pair; pass
    ``b""`` for an envelope without state."""
    _write_envelope(path, meta, lambda f: f.write(blob))


def _read_head(f: BinaryIO, path) -> dict:
    """An envelope's meta, ``f`` left at the start of its blob.  Raises
    ``ValueError`` naming the file when this module did not write it."""
    foreign = ValueError(
        f"{path}: foreign checkpoint — not a {FRAMEWORK} envelope (the JAX "
        "package's msgpack envelopes, for one, cannot be resumed here)")
    pre = f.read(len(MAGIC) + _LEN.size)
    if len(pre) < len(MAGIC) + _LEN.size or not pre.startswith(MAGIC):
        raise foreign
    (n,) = _LEN.unpack_from(pre, len(MAGIC))
    try:
        head = json.loads(f.read(n))
    except ValueError:
        raise foreign from None
    if not isinstance(head, dict) or head.get("framework") != FRAMEWORK:
        raise foreign
    return head["meta"]


def load_envelope(path) -> Tuple[dict, bytes]:
    """Read a :func:`save_envelope` file: ``(meta, blob)``.  Raises
    ``ValueError`` naming the file when this module did not write it."""
    with open(path, "rb") as f:
        return _read_head(f, path), f.read()


def require_version(meta: dict, supported, *, what: str = "checkpoint"):
    """Validate an envelope's ``version`` against the supported set and
    return it; unknown or newer versions are a ``ValueError``."""
    version = meta.get("version")
    if version not in tuple(supported):
        raise ValueError(f"unsupported {what} version: {version!r} "
                         f"(supported: {sorted(supported)})")
    return version


TRAIN_STATE_VERSION = 1


def save_train_state(path, params, opt_state, step: int, data_cursor: int) -> None:
    """Atomically write a training state: the parameter tree, the optimizer
    state, the step count and the data cursor (the position of
    ``data.tokens.token_batches`` to resume from).  The blob is stored
    uncompressed: float weights and moments shrink by about a tenth under
    zlib, which took 115 s for smollm-135m's 1.9 GB of parameters and AdamW
    state on the host of an NVIDIA H100 80GB HBM3 machine (7 s stored).
    The state is written one leaf at a time (:func:`write_state`)."""
    meta = {"kind": "train_state", "version": TRAIN_STATE_VERSION,
            "step": int(step), "cursor": int(data_cursor)}
    state = {"params": params, "opt": opt_state}
    _write_envelope(path, meta, lambda f: write_state(f, state, level=0))


def load_train_state(path, params_like, opt_like, device="cuda"):
    """Read :func:`save_train_state`'s file -> (params, opt_state, step,
    cursor), the tensors new on ``device`` (the card unless the caller
    asks for the CPU).  ``params_like`` and ``opt_like`` give the structure;
    another structure, another version or a foreign file (the JAX package's
    msgpack checkpoints among them) is a ``ValueError``."""
    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    with open(path, "rb") as f:
        meta = _read_head(f, path)
        if meta.get("kind") != "train_state":
            raise ValueError(f"{path}: not a training state (kind {meta.get('kind')!r})")
        require_version(meta, (TRAIN_STATE_VERSION,), what="train state")
        st = read_state(f, {"params": params_like, "opt": opt_like}, device=dev)
    return st["params"], st["opt"], int(meta["step"]), int(meta["cursor"])
