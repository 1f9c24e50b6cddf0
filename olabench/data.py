"""The benchmark's TPC-H ``lineitem``, made on the device from ``--seed``.

The rows follow TPC-H 3.0.1 §4.2.3's definitions of ORDERS and LINEITEM
(dates from §4.2.2.12): each order has an orderdate uniform in
[STARTDATE, ENDDATE - 151 days] and 1 to 7 line items; a line's partkey is
uniform in [1, SF · 200,000] and its supplier is one of the part's four
(``L_SUPPKEY``'s formula); quantity is uniform in 1..50, extendedprice is
quantity · P_RETAILPRICE(partkey), discount 0.00..0.10, tax 0.00..0.08;
shipdate is orderdate + 1..121 days, receiptdate shipdate + 1..30;
returnflag is R or A at random where receiptdate <= CURRENTDATE
(1995-06-17), else N; linestatus is O where shipdate > CURRENTDATE, else F.
Orders are drawn until the table has the configuration's rows (the last
order cut short), and orderkeys are the spec's sparse keys (the first 8 of
every 32).  The reference calls this again after the window, with the
same seed, and gets the same columns bitwise (``fingerprint`` checks it).

Encodings (36 B a row with the mask the port adds):
  shipdate int32 day in [0, 2526) from 1992-01-02; discount float32 k/100,
  k in [0, 11); quantity float32 in {1 .. 50}; extendedprice float32
  dollars; tax float32 k/100, k in [0, 9); rfls int32, the index of
  (returnflag, linestatus) in :data:`RFLS`; suppkey int32 L_SUPPKEY - 1;
  orderkey int32.

As a table module (``tables.py``) it is the default: it gives
:data:`COLUMNS`, :func:`generate`, :func:`check_columns`,
:func:`dimensions` (none) and :func:`tiny_cut`.

The layout (``layout``) is the one the port's loading path gives the rows:
one global permutation drawn by ``torch.randperm`` from ``perm_seed``, split
into P contiguous runs at ``linspace(0, n, P + 1)``, each run laid out in
chunks of L rows.  The reference rebuilds it from the seed alone.
"""
from __future__ import annotations

from datetime import date
from typing import Dict, Iterator, List, Tuple

import torch

BASE = date(1992, 1, 2)  # day 0: the first shipdate STARTDATE allows
DAYS = 2526  # shipdates 1992-01-02 .. 1998-12-01
ORDER_FIRST = (date(1992, 1, 1) - BASE).days  # STARTDATE
ORDER_LAST = (date(1998, 12, 31) - BASE).days - 151  # ENDDATE - 151 days
CURRENT = (date(1995, 6, 17) - BASE).days  # CURRENTDATE
#: the (returnflag, linestatus) pairs the spec's rules can give, in Q1's order
RFLS = ("AF", "NF", "NO", "RF")
COLUMNS = ("shipdate", "discount", "quantity", "extendedprice", "tax", "rfls",
           "suppkey")
SEED_MOD = 1 << 62
_I32 = torch.int32


def data_seed(seed: int) -> int:
    return (4 * int(seed)) % SEED_MOD


def perm_seed(seed: int) -> int:
    return (4 * int(seed) + 1) % SEED_MOD


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def retail_cents(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE in cents: 90000 + (partkey / 10) mod 20001 + 100 · (partkey mod 1000)."""
    return 90000 + torch.remainder(partkey // 10, 20001) + 100 * torch.remainder(partkey, 1000)


def supplier_of(partkey: torch.Tensor, i: torch.Tensor, suppliers: int) -> torch.Tensor:
    """L_SUPPKEY - 1: (partkey + i · (S/4 + (partkey - 1)/S)) mod S, i in 0..3."""
    S = int(suppliers)
    return torch.remainder(partkey + i * (S // 4 + (partkey - 1) // S), S)


def sparse_orderkey(index: torch.Tensor) -> torch.Tensor:
    """The spec's sparse O_ORDERKEY of the order numbered ``index`` from 0:
    only the first 8 keys of every 32 are used."""
    return (index >> 3) * 32 + (index & 7) + 1


def generate(config: dict, seed: int, device, *, orderkey: bool = True
             ) -> Dict[str, torch.Tensor]:
    """The configuration's ``rows`` lineitem rows as flat ``[rows]`` columns
    on ``device``: the seven query columns and, with ``orderkey``, the key a
    deployment holds beside them."""
    rows, S = int(config["rows"]), int(config["suppliers"])
    parts = int(config["parts"])
    g = _generator(data_seed(seed), device)

    def ints(lo, hi, n=rows):
        return torch.randint(lo, hi, (n,), generator=g, device=device, dtype=_I32)

    # orders: 1..7 lines each, drawn until they cover the rows (mean 4)
    n_orders = rows // 4 + 8 * int((rows / 4) ** 0.5) + 64
    lines = ints(1, 8, n_orders).long()
    covered = int(lines.sum())
    if covered < rows:
        raise ValueError(f"{n_orders} orders cover {covered} < {rows} rows")
    order = torch.repeat_interleave(torch.arange(n_orders, device=device, dtype=_I32),
                                    lines, output_size=covered)[:rows]
    del lines
    orderdate = ints(ORDER_FIRST, ORDER_LAST + 1, n_orders)[order]

    partkey = ints(1, parts + 1)
    suppkey = supplier_of(partkey, ints(0, 4), S).to(_I32)
    quantity = ints(1, 51)
    price = (quantity * retail_cents(partkey)).to(torch.float64) / 100.0
    del partkey
    discount = (ints(0, 11).to(torch.float64) / 100.0).float()
    tax = (ints(0, 9).to(torch.float64) / 100.0).float()
    shipdate = orderdate + ints(1, 122)
    del orderdate
    receipt = shipdate + ints(1, 31)
    ra = ints(0, 2) * 3  # A (0) or R (3) where the line was received by CURRENTDATE
    rfls = torch.where(receipt <= CURRENT, ra, 1 + (shipdate > CURRENT).to(_I32))
    del receipt, ra
    cols = {"shipdate": shipdate, "discount": discount, "quantity": quantity.float(),
            "extendedprice": price.float(), "tax": tax, "rfls": rfls, "suppkey": suppkey}
    if orderkey:
        cols["orderkey"] = sparse_orderkey(order).to(_I32)
    return cols


def check_columns(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The :data:`COLUMNS` again, for the reference: the table without the
    orderkey, which no query reads."""
    return generate(config, seed, device, orderkey=False)


def dimensions(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """No dimension tables: every query here reads lineitem alone."""
    return {}


def tiny_cut(config: dict) -> dict:
    """The configuration's own sizes cut to a CPU test's table."""
    return dict(config, suppliers=1000, parts=20000)


def fingerprint(cols: Dict[str, torch.Tensor], columns=COLUMNS) -> Dict[str, int]:
    """An exact checksum a column of ``columns``: the sum of its 32-bit words."""
    return {k: int(v.view(torch.int32).sum(dtype=torch.int64)) for k, v in cols.items()
            if k in columns}


class Layout:
    """Where each row of the table lies after the port's loading path:
    partition p holds ``perm[bounds[p]:bounds[p + 1]]`` in order, chunk c of
    it rows ``[c L, (c + 1) L)``, and round r chunks ``[r W, (r + 1) W)``."""

    def __init__(self, rows: int, seed: int, partitions: int, chunk_len: int,
                 rounds: int, device):
        self.rows, self.P, self.L, self.R = rows, partitions, chunk_len, rounds
        self.device = device
        self.perm = torch.randperm(rows, generator=_generator(perm_seed(seed), device),
                                   device=device)
        b = torch.linspace(0, rows, partitions + 1, dtype=torch.float64)
        self.bounds: List[int] = b.to(torch.int64).tolist()
        sizes = [self.bounds[p + 1] - self.bounds[p] for p in range(partitions)]
        self.C = max(-(-n // chunk_len) for n in sizes)
        if self.C % rounds:
            raise ValueError(f"C={self.C} chunks do not divide into {rounds} rounds")
        self.W = self.C // rounds
        self.sizes = sizes

    def round_rows(self, r: int) -> torch.Tensor:
        """The table's row ids that round ``r`` covers, every partition's."""
        span = self.W * self.L
        ids = [self.perm[self.bounds[p] + min(r * span, n):self.bounds[p] + min((r + 1) * span, n)]
               for p, n in enumerate(self.sizes)]
        return torch.cat(ids)

    def round_of(self, lo: int, hi: int) -> int:
        """The round a chunk range ``[lo, hi)`` is, or a ValueError."""
        if lo % self.W or hi - lo != self.W or not 0 <= lo < self.C:
            raise ValueError(f"chunk range [{lo}, {hi}) is no round of width {self.W}")
        return lo // self.W


def gather_rounds(cols: Dict[str, torch.Tensor], layout: Layout, rounds
                  ) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
    """(r, the columns of round r's rows) for each r of ``rounds``: every
    column of ``cols``, the columns the reference reads."""
    for r in rounds:
        ids = layout.round_rows(r)
        yield r, {k: v[ids] for k, v in cols.items()}
