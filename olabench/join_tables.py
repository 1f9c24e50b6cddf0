"""TPC-H lineitem beside replicated ORDERS and PART, made on the device from
``--seed``: the table module (``tables.py``) of configurations that join.

- **lineitem**: :func:`olabench.data.generate`'s columns, made by it, plus
  ``partkey`` (L_PARTKEY - 1), the draw it makes and drops: its generator
  seeded as it seeds it and called as it calls it up to that draw.  40 B a
  row with the mask.  ``orderkey`` keeps the spec's sparse O_ORDERKEY.
- **ORDERS** (TPC-H 3.0.1 §4.2.3), indexed by the dense order number
  (:func:`dense_order` of the sparse key): ``o_orderdate``, the per-order
  date that lineitem's shipdates follow (the same draw again), and
  ``o_custkey`` (O_CUSTKEY - 1), uniform over the customers whose
  C_CUSTKEY is not a multiple of 3, from a generator of its own.
- **PART**: ``p_promo``, 1 where P_TYPE's first syllable is PROMO (uniform
  over the spec's six), from a generator of its own.

So lineitem's draws stay ``data.generate``'s, and the dimension tables are
made again from the seed alone for the reference.
"""
from __future__ import annotations

from typing import Dict

import torch

from olabench import data

COLUMNS = (*data.COLUMNS, "orderkey", "partkey")
#: P_TYPE's first syllables (§4.2.2.13); PROMO is the last
TYPE_SYLLABLES = ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
_I32 = torch.int32


def custkey_seed(seed: int) -> int:
    return (4 * int(seed) + 2) % data.SEED_MOD


def part_seed(seed: int) -> int:
    return (4 * int(seed) + 3) % data.SEED_MOD


def orders(rows: int) -> int:
    """The orders ``data.generate`` draws for ``rows`` lines (the last ones
    beyond the rows it keeps)."""
    return rows // 4 + 8 * int((rows / 4) ** 0.5) + 64


def dense_order(orderkey: torch.Tensor) -> torch.Tensor:
    """The dense order number of a sparse O_ORDERKEY: the spec's key rule
    (the first 8 keys of every 32) read backwards, a perfect hash."""
    k = orderkey - 1
    return (k >> 5) * 8 + (k & 7)


def _order_draws(config: dict, seed: int, device):
    """``data.generate``'s first draws again: (each order's date, a function
    that makes the next draw, each line's partkey)."""
    rows, n = int(config["rows"]), orders(int(config["rows"]))
    g = torch.Generator(device=device)
    g.manual_seed(data.data_seed(seed))

    def ints(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=g, device=device, dtype=_I32)

    ints(1, 8, n)  # the lines of each order
    orderdate = ints(data.ORDER_FIRST, data.ORDER_LAST + 1, n)
    return orderdate, lambda: ints(1, int(config["parts"]) + 1, rows)


def generate(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's ``rows`` lineitem rows as flat ``[rows]`` columns
    on ``device``: ``data.generate``'s, and ``partkey``."""
    cols = data.generate(config, seed, device)
    orderdate, partkey = _order_draws(config, seed, device)
    del orderdate
    cols["partkey"] = partkey() - 1
    return cols


def check_columns(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The :data:`COLUMNS` again, for the reference: the whole table."""
    return generate(config, seed, device)


def dimensions(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """ORDERS' ``o_custkey`` and ``o_orderdate`` by dense order number, and
    PART's ``p_promo`` by L_PARTKEY - 1, as ``[n]`` int32 on ``device``."""
    orderdate, _ = _order_draws(config, seed, device)
    customers, parts = int(config["customers"]), int(config["parts"])
    g = torch.Generator(device=device)
    g.manual_seed(custkey_seed(seed))
    k = torch.randint(0, customers - customers // 3, orderdate.shape, generator=g,
                      device=device, dtype=_I32)
    g.manual_seed(part_seed(seed))
    syllable = torch.randint(0, len(TYPE_SYLLABLES), (parts,), generator=g,
                             device=device, dtype=_I32)
    # the k-th C_CUSTKEY that is not a multiple of 3, less one
    return {"o_custkey": k + k // 2, "o_orderdate": orderdate,
            "p_promo": (syllable == len(TYPE_SYLLABLES) - 1).to(_I32)}


def tiny_cut(config: dict) -> dict:
    """The configuration's own sizes cut to a CPU test's table."""
    return dict(config, suppliers=1000, parts=20000, customers=1500)
