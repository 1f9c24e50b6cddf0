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
(:func:`serialize_state`) is zlib-compressed: an 8-byte header length, a
JSON table (the state's structure and each leaf's dtype name, shape and
byte range) and every leaf's little-endian raw bytes (a bfloat16 leaf's
16-bit words), so states come back bit for bit, ±inf included. Writes are
atomic (a temporary file, then ``replace``). A file that does not start
with ``MAGIC`` — the reference's msgpack envelope, say — is refused as
foreign with a ``ValueError``.
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

from repro_torch.uda import tree_leaves, tree_map

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


def serialize_state(state: Any, level: int = 6) -> bytes:
    """A state (tensors in tuples, NamedTuples, lists and dicts) -> bytes,
    zlib-compressed at ``level`` (0: stored, for weights that do not
    compress)."""
    table, raw, off = [], [], 0
    for leaf in tree_leaves(state):
        t = leaf.detach().cpu().contiguous()
        bf16 = t.dtype == torch.bfloat16  # NumPy has no bfloat16: its 16-bit words
        a = (t.view(torch.int16) if bf16 else t).numpy()
        b = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        table.append({"dtype": "bfloat16" if bf16 else a.dtype.name, "shape": list(a.shape),
                      "offset": off, "nbytes": len(b)})
        raw.append(b)
        off += len(b)
    head = json.dumps({"treedef": treedef(state), "leaves": table}).encode()
    return zlib.compress(_LEN.pack(len(head)) + head + b"".join(raw), level)


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
        bf16 = rec["dtype"] == "bfloat16"
        a = np.frombuffer(raw, dtype=np.dtype(np.int16 if bf16 else rec["dtype"]).newbyteorder("<"),
                          count=int(np.prod(rec["shape"], dtype=np.int64)),
                          offset=start).reshape(rec["shape"])
        a = a.astype(a.dtype.newbyteorder("="), copy=True)  # native, writable
        t = torch.from_numpy(a)
        leaves.append((t.view(torch.bfloat16) if bf16 else t).to(device))
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


TRAIN_STATE_VERSION = 1


def save_train_state(path, params, opt_state, step: int, data_cursor: int) -> None:
    """Atomically write a training state: the parameter tree, the optimizer
    state, the step count and the data cursor (the position of
    ``data.tokens.token_batches`` to resume from).  The blob is stored
    uncompressed: float weights and moments shrink by about a tenth under
    zlib, which took 115 s for smollm-135m's 1.9 GB of parameters and AdamW
    state on the host of an NVIDIA H100 80GB HBM3 machine (7 s stored)."""
    meta = {"kind": "train_state", "version": TRAIN_STATE_VERSION,
            "step": int(step), "cursor": int(data_cursor)}
    save_envelope(path, meta, serialize_state({"params": params, "opt": opt_state}, level=0))


def load_train_state(path, params_like, opt_like, device="cuda"):
    """Read :func:`save_train_state`'s file -> (params, opt_state, step,
    cursor), the tensors new on ``device`` (the card unless the caller
    asks for the CPU).  ``params_like`` and ``opt_like`` give the structure;
    another structure, another version or a foreign file (the JAX package's
    msgpack checkpoints among them) is a ``ValueError``."""
    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    meta, blob = load_envelope(path)
    if meta.get("kind") != "train_state":
        raise ValueError(f"{path}: not a training state (kind {meta.get('kind')!r})")
    require_version(meta, (TRAIN_STATE_VERSION,), what="train state")
    st = deserialize_state(blob, {"params": params_like, "opt": opt_like}, device=dev)
    return st["params"], st["opt"], int(meta["step"]), int(meta["cursor"])
