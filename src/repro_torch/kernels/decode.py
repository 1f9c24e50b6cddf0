"""K1's column-decode stage on Hopper — port of ``_decode_chunk``
(``repro/kernels/fused_agg.py:224-238``).

:func:`decode` turns physical encoded columns (``data/encodings.py``)
into their logical columns: on CUDA tensors in ONE launch of
``pf_decode`` (``csrc/decode.cu``) for up to :data:`MAX_COLUMNS` columns,
on CPU tensors through the plain versions ``ref.decode_dict`` and
``ref.decode_bitpacked``.  The reference decodes in the Pallas body of K1
and K2; the port's closures are PyTorch, so the decode runs ahead of them
and writes the logical columns to device memory (``PERF.md`` counts what
that costs; fusing it is ROADMAP Queue 2 work).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import _runtime as RT

MAX_COLUMNS = 32  # columns in one pf_decode launch (csrc kMaxCols)
SMEM_TABLE_BYTES = 32 * 1024  # value tables up to this size sit in shared memory
_TABLE_COLS = 9  # int64 slots per column row (csrc kTableCols)
_CODE_DTYPES = {torch.int8: 1, torch.int16: 2}


def _lib() -> ctypes.CDLL:
    return RT.bind(_build.load("decode"), pf_decode=(1, 1))


@functools.lru_cache(maxsize=256)
def _value_table(enc, device: torch.device) -> torch.Tensor:
    """A dictionary's value table on ``device``, made once per encoding."""
    return enc.table(device)


def _check(x, enc):
    from repro_torch.data.encodings import DictEncoding, torch_dtype

    if not isinstance(x, torch.Tensor) or x.ndim < 1:
        raise ValueError("an encoded column must be a tensor of rank >= 1")
    want = torch_dtype(enc.physical_dtype())
    if x.dtype != want:
        raise ValueError(f"encoded column has dtype {x.dtype}, its encoding "
                         f"stores {want}")
    if isinstance(enc, DictEncoding):
        if not 1 <= len(enc.values) <= 32767 or x.dtype not in _CODE_DTYPES:
            raise ValueError("dictionary decode takes int8/int16 codes into "
                             "a table of 1 to 32767 values")
    elif not 1 <= enc.bits <= 32:
        raise ValueError(f"bit width {enc.bits} outside [1, 32]")
    return isinstance(enc, DictEncoding)


def decode(columns):
    """``columns``: a list of ``(physical tensor, encoding)`` on one device
    -> the logical tensors, in order.  Dictionary columns come back in
    ``logical_dtype`` with the codes' shape; bit-packed columns as int32
    with the trailing axis ``lanes`` times longer, cast afterwards when
    ``logical_dtype`` is not int32."""
    if not columns:
        return []
    dev = columns[0][0].device if isinstance(columns[0][0], torch.Tensor) else None
    kinds = [_check(x, enc) for x, enc in columns]
    if any(x.device != dev for x, _ in columns):
        raise ValueError("decode: every column must be on one device")
    if RT.route(dev) == "plain":
        RT.plain("decode", -(-len(columns) // MAX_COLUMNS))
        out = [ref.decode_dict(x, _value_table(enc, dev)) if is_dict
               else ref.decode_bitpacked(x, enc.bits)
               for (x, enc), is_dict in zip(columns, kinds)]
    else:
        out = []
        for i in range(0, len(columns), MAX_COLUMNS):
            out += _launch(columns[i:i + MAX_COLUMNS], kinds[i:i + MAX_COLUMNS], dev)
    from repro_torch.data.encodings import torch_dtype

    return [y if is_dict or enc.logical_dtype == "int32"
            else y.to(torch_dtype(enc.logical_dtype))
            for y, (_, enc), is_dict in zip(out, columns, kinds)]


def _launch(columns, kinds, dev):
    """One ``pf_decode`` launch over at most MAX_COLUMNS columns."""
    table = np.zeros((len(columns), _TABLE_COLS), np.int64)
    outs, keep = [], []  # keep: contiguous copies the table points into
    for i, ((x, enc), is_dict) in enumerate(zip(columns, kinds)):
        x = x.contiguous()
        keep.append(x)
        if is_dict:
            tab = _value_table(enc, dev)
            y = torch.empty(x.shape, dtype=tab.dtype, device=dev)
            nbytes = tab.numel() * tab.element_size()
            table[i] = (0, x.element_size(), tab.element_size(), tab.numel(),
                        y.numel(), x.data_ptr(), y.data_ptr(), tab.data_ptr(),
                        int(nbytes <= SMEM_TABLE_BYTES))
        else:
            y = torch.empty((*x.shape[:-1], x.shape[-1] * enc.lanes),
                            dtype=torch.int32, device=dev)
            table[i] = (1, enc.bits, 4, 0, y.numel(), x.data_ptr(),
                        y.data_ptr(), 0, 0)
        outs.append(y)
    lib = _lib()
    RT.launch(lib, lib.pf_decode, ctypes.c_void_p(table.ctypes.data),
              len(columns), device=dev, count="decode")
    return outs
