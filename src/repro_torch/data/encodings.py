"""Compressed column encodings — port of ``repro/data/encodings.py:42-159``.

An encoded source ships some columns in a smaller *physical* form, and
the scan decodes them back to the *logical* column before the query's
closures see them.  The decode is exact, so every aggregate over an
encoded copy is bitwise the plain copy's:

``DictEncoding``
    Low-cardinality columns (TPC-H ``discount``: 11 values, ``quantity``:
    50, ``tax``: 9) as int8/int16 codes into a value table; decode is the
    gather ``values[code]`` and moves the original bit patterns.
``BitPackedEncoding``
    Bounded non-negative ints (``shipdate`` < 2526, ``rfls`` < 4) packed
    little-endian into int32 words along the trailing axis, ``32 // bits``
    per word; decode is shift-and-mask.

Encoding runs on the host in NumPy (:func:`encode_array`, byte-identical
to the reference's), so either package writes and reads the other's
``EncodedSource`` directories.  Decoding runs on the device:
:func:`decode_cols` turns every encoded column of a slice into its
logical column in ONE launch of ``pf_decode`` (``kernels/decode.py``) on
CUDA tensors, and runs the plain version (``kernels/ref.py``) on CPU
tensors.  The reference decodes inside its fused kernel's body; the
port's closures are PyTorch and need logical columns, so the decode is a
launch of its own before them (ROADMAP Queue 2: fusing the closures).

Encodings are hashable NamedTuples with the reference's fields, so
``normalize_encodings`` gives the same name-sorted tuple in both packages.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a NumPy dtype name ("float32", "int8", ...)."""
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def dtype_name(dtype) -> str:
    """NumPy's name for a NumPy or torch dtype ("float32", not
    ``torch.float32``): what a ``ColumnSpec`` records."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


class DictEncoding(NamedTuple):
    """Dictionary code column: physical small-int codes, logical =
    values[code].  ``values`` is the sorted tuple of distinct logical
    values (Python numbers); ``code_dtype`` the physical dtype name,
    ``logical_dtype`` the decoded one."""

    values: Tuple[float, ...]
    code_dtype: str = "int8"
    logical_dtype: str = "float32"

    @property
    def lanes(self) -> int:
        return 1  # one code per logical element

    def physical_dtype(self) -> str:
        return self.code_dtype

    def table(self, device=None) -> torch.Tensor:
        """The value table as a ``logical_dtype`` tensor on ``device``."""
        return torch.from_numpy(
            np.asarray(self.values, dtype=self.logical_dtype)).to(device)


class BitPackedEncoding(NamedTuple):
    """``bits``-wide non-negative ints packed into int32 words
    (little-endian within the word) along the trailing axis; lanes =
    32 // bits values per word, and the logical trailing length must be a
    multiple of lanes."""

    bits: int
    logical_dtype: str = "int32"

    @property
    def lanes(self) -> int:
        return 32 // self.bits

    def physical_dtype(self) -> str:
        return "int32"


Encoding = DictEncoding | BitPackedEncoding


# ---------------------------------------------------------------------------
# host-side encode (NumPy), byte-identical to the reference
# ---------------------------------------------------------------------------

def dict_encoding_for(arr) -> DictEncoding:
    """Build a DictEncoding from the distinct values of ``arr`` (host)."""
    a = np.asarray(arr)
    values = np.unique(a)
    if values.size > np.iinfo(np.int16).max:
        raise ValueError(f"dictionary too large: {values.size} distinct values")
    code_dtype = "int8" if values.size <= np.iinfo(np.int8).max + 1 else "int16"
    return DictEncoding(values=tuple(values.tolist()), code_dtype=code_dtype,
                        logical_dtype=a.dtype.name)


def encode_array(arr, enc: Encoding) -> np.ndarray:
    """Host encode: logical array -> physical array (last axis packed for
    bit-packing).  Raises if the data does not fit the encoding exactly."""
    a = np.asarray(arr)
    if isinstance(enc, DictEncoding):
        table = np.asarray(enc.values, dtype=enc.logical_dtype)
        codes = np.searchsorted(table, a)
        codes = np.clip(codes, 0, table.size - 1)
        if not np.array_equal(table[codes], a):
            raise ValueError("dict encoding: values outside the dictionary")
        return codes.astype(enc.code_dtype)
    bits, lanes = enc.bits, enc.lanes
    if a.dtype.kind not in "iu":
        raise ValueError(f"bit-packing needs an integer column, got {a.dtype}")
    if a.min() < 0 or a.max() >= (1 << bits):
        raise ValueError(f"bit-packing {bits} bits: values outside [0, 2^{bits})")
    if a.shape[-1] % lanes:
        raise ValueError(
            f"bit-packing {bits} bits: trailing length {a.shape[-1]} not a "
            f"multiple of {lanes} lanes")
    words = a.astype(np.int64).reshape(*a.shape[:-1], a.shape[-1] // lanes, lanes)
    shifts = (bits * np.arange(lanes)).astype(np.int64)
    return (words << shifts).sum(axis=-1).astype(np.int32)


# ---------------------------------------------------------------------------
# device-side decode
# ---------------------------------------------------------------------------

def decode_block(x: torch.Tensor, enc: Encoding | None) -> torch.Tensor:
    """Decode one physical tensor back to its logical values (one
    ``pf_decode`` launch on a CUDA tensor, the plain version on a CPU
    one); ``enc=None`` passes ``x`` through."""
    if enc is None:
        return x
    from repro_torch.kernels import decode  # local: kernels import this module

    return decode.decode([(x, enc)])[0]


def decode_cols(cols: dict, encodings) -> dict:
    """Decode every encoded column of a slice dict in ONE launch (CUDA
    tensors); plain columns pass through untouched.  ``encodings`` is a
    tuple of (name, Encoding)."""
    enc_map = dict(encodings)
    names = [k for k in cols if enc_map.get(k) is not None]
    if not names:
        return dict(cols)
    from repro_torch.kernels import decode

    out = decode.decode([(cols[k], enc_map[k]) for k in names])
    return {**cols, **dict(zip(names, out))}


def normalize_encodings(encodings) -> tuple:
    """Canonical hashable form: name-sorted tuple of (name, Encoding)."""
    return tuple(sorted(dict(encodings).items()))
