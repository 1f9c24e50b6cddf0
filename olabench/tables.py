"""A configuration's tables, made by the module its file names.

A configuration file may name, under ``"table_module"``, the module under
``olabench`` that makes its tables; without the key it is ``olabench.data``
(TPC-H lineitem alone), so a later cell brings its tables as a new file.
The module gives

- ``COLUMNS``: the scanned table's columns that the fingerprint and the
  reference read;
- ``generate(config, seed, device)``: the scanned table from the seed, flat
  ``[rows]`` 32-bit columns on ``device``, made at set-up;
- ``check_columns(config, seed, device)``: the ``COLUMNS`` made again from
  the seed after the window, for the reference;
- ``dimensions(config, seed, device)``: the replicated dimension tables
  from the seed, ``{name: [n] 32-bit tensor}`` on ``device``, made at
  set-up once the table is loaded, and again for the reference;

and may give ``tiny_cut(config)``: its own sizes cut to a CPU test's table
(``tests/tiny.py`` sets the rows and the layout).
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from olabench import data

DEFAULT = "olabench.data"


def module(config: dict):
    name = config.get("table_module", DEFAULT)
    if not name.startswith("olabench."):
        raise ValueError(f"table module {name!r} is not under olabench")
    return importlib.import_module(name)


def dim_fingerprint(dims: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """An exact checksum of each dimension column, keyed ``dim.<name>``."""
    return {"dim." + k: v for k, v in data.fingerprint(dims, dims.keys()).items()}


def tiny_cut(config: dict) -> dict:
    mod = module(config)
    return mod.tiny_cut(config) if hasattr(mod, "tiny_cut") else config
