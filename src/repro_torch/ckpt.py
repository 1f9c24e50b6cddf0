"""Serialize / Deserialize — the paper's UDA transfer extension, for
checkpoints of sessions (``Session.pause`` / ``Session.resume``).

Port of ``repro/checkpoint/ckpt.py:52-125`` in a format of its own: the
reference's msgpack envelope needs ``msgpack`` (and optionally
``zstandard``), which the port does not depend on.  Standard library and
NumPy only.

An *envelope* file is ``MAGIC``, the byte length of a JSON header as 8
little-endian bytes, the header — ``{"framework": "repro_torch", "meta":
meta}``, readable without the blob — and the state *blob*.  A blob
(:func:`serialize_state`) is zlib-compressed: an 8-byte header length, a
JSON table (the state's structure and each leaf's dtype name, shape and
byte range) and every leaf's little-endian raw bytes, so states come back
bit for bit, ±inf included.  Writes are atomic (a temporary file, then
``replace``).  A file that does not start with ``MAGIC`` — the reference's
msgpack envelope, say — is refused as foreign with a ``ValueError``.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from pathlib import Path
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.uda import tree_map

FRAMEWORK = "repro_torch"
MAGIC = b"REPRO_TORCH_CKPT\x00"
_LEN = struct.Struct("<Q")


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


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def serialize_state(state: Any) -> bytes:
    """A state (tensors in tuples, NamedTuples, lists and dicts) -> bytes."""
    table, raw, off = [], [], 0
    for leaf in _leaves(state):
        a = leaf.detach().cpu().contiguous().numpy()
        b = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        table.append({"dtype": a.dtype.name, "shape": list(a.shape),
                      "offset": off, "nbytes": len(b)})
        raw.append(b)
        off += len(b)
    head = json.dumps({"treedef": treedef(state), "leaves": table}).encode()
    return zlib.compress(_LEN.pack(len(head)) + head + b"".join(raw), 6)


def deserialize_state(buf: bytes, like: Any, device="cpu") -> Any:
    """Bytes from :func:`serialize_state` -> the state, its leaves on
    ``device``.  ``like`` gives the structure (a skeleton built from the
    configuration; its leaves' values are not read); a blob of another
    structure is a ``ValueError``."""
    raw = zlib.decompress(buf)
    (n,) = _LEN.unpack_from(raw)
    head = json.loads(raw[_LEN.size:_LEN.size + n])
    want = treedef(like)
    if head["treedef"] != want:
        raise ValueError(
            f"checkpoint state structure {head['treedef']!r} does not match "
            f"this session's {want!r}")
    base = _LEN.size + n
    leaves = []
    for rec in head["leaves"]:
        start = base + rec["offset"]
        a = np.frombuffer(raw, dtype=np.dtype(rec["dtype"]).newbyteorder("<"),
                          count=int(np.prod(rec["shape"], dtype=np.int64)),
                          offset=start).reshape(rec["shape"])
        a = a.astype(a.dtype.newbyteorder("="), copy=True)  # native, writable
        leaves.append(torch.from_numpy(a).to(device))
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def save_envelope(path, meta: dict, blob: bytes) -> None:
    """Atomically write a (JSON meta header, state blob) pair; pass
    ``b""`` for an envelope without state."""
    head = json.dumps({"framework": FRAMEWORK, "meta": meta}).encode()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(MAGIC + _LEN.pack(len(head)) + head + blob)
    tmp.replace(path)


def load_envelope(path) -> Tuple[dict, bytes]:
    """Read a :func:`save_envelope` file: ``(meta, blob)``.  Raises
    ``ValueError`` naming the file when this module did not write it."""
    data = Path(path).read_bytes()
    foreign = ValueError(
        f"{path}: foreign checkpoint — not a {FRAMEWORK} envelope (the JAX "
        "package's msgpack envelopes, for one, cannot be resumed here)")
    if not data.startswith(MAGIC) or len(data) < len(MAGIC) + _LEN.size:
        raise foreign
    (n,) = _LEN.unpack_from(data, len(MAGIC))
    start = len(MAGIC) + _LEN.size
    try:
        head = json.loads(data[start:start + n])
    except ValueError:
        raise foreign from None
    if not isinstance(head, dict) or head.get("framework") != FRAMEWORK:
        raise foreign
    return head["meta"], data[start + n:]


def require_version(meta: dict, supported, *, what: str = "checkpoint"):
    """Validate an envelope's ``version`` against the supported set and
    return it; unknown or newer versions are a ``ValueError``."""
    version = meta.get("version")
    if version not in tuple(supported):
        raise ValueError(f"unsupported {what} version: {version!r} "
                         f"(supported: {sorted(supported)})")
    return version
