"""Synthetic TPC-H lineitem — the paper's evaluation workload, on the device.

Port of ``repro/data/tpch.py:32-211,249+``.  The generator draws the same
distributions as the reference (dbgen's for the columns the paper's queries
touch) from a seeded ``torch.Generator`` on the given device, so a card
makes hundreds of millions of rows in seconds.  The draws are not the
reference's numbers (the generators differ); the parity tests hand both
packages the reference's numpy columns instead.

``exact_answer`` is the float64 oracle over flat columns or any chunk
source (``data/source.py``).

Column encodings (all numeric, columnar):
  shipdate  int32  days in [0, 2526)   (1992-01-02 .. 1998-12-01)
  discount  float32 in {0.00 .. 0.10}
  quantity  float32 in {1 .. 50}
  extendedprice float32
  tax       float32 in {0.00 .. 0.08}
  rfls      int32 in [0, 4)   returnflag×linestatus combined group
  suppkey   int32 in [0, num_suppliers)
  orderkey  int32 in [0, num_orders)   (join scenarios only)
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch._device import resolve_device

DAYS = 2526  # dbgen shipdate span
Q6_LOW_WINDOW = (420, 785)  # ~1 year starting '1993-02-26'
Q6_HIGH_WINDOW = (420, 421)  # the single day '1993-02-26'
Q1_WINDOW = (2434, 2526)  # ['1998-09-01','1998-12-01']
NUM_NATIONS = 25

# Large-domain Q1 (paper §5.3: 1M groups, scaled): suppkey spans 100k raw
# ids, folded into 2**13 hash buckets (repro_torch.gla.hash_bucket).
Q1_LARGE_SUPPLIERS = 100_000
Q1_LARGE_BUCKET_BITS = 13


def _generator(seed: int, device) -> tuple:
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g, dev


def generate_lineitem(
    rows: int, *, num_suppliers: int = 1000, seed: int = 7, device="cuda"
) -> Dict[str, torch.Tensor]:
    """``rows`` lineitem rows as flat ``[rows]`` columns on ``device``."""
    g, dev = _generator(seed, device)

    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (rows,), generator=g, device=dev, dtype=dtype)

    def cents(hi):  # k / 100 for k uniform in [0, hi), rounded once to f32
        return (ints(0, hi, torch.int32).to(torch.float64) / 100.0).float()

    u = torch.rand(rows, generator=g, device=dev, dtype=torch.float64)
    return {
        "shipdate": ints(0, DAYS, torch.int32),
        "discount": cents(11),
        "quantity": ints(1, 51, torch.int32).float(),
        "extendedprice": ((900.0 + u * (105000.0 - 900.0)) / 1000.0).float(),
        "tax": cents(9),
        "rfls": ints(0, 4, torch.int32),
        "suppkey": ints(0, num_suppliers, torch.int32),
    }


def supplier_nation_table(num_suppliers: int = 1000, seed: int = 11,
                          device="cuda"):
    """Replicated dimension side: suppkey -> nationkey, plus validity —
    supplier ⋈ nation pre-joined in memory (paper §5.4)."""
    g, dev = _generator(seed, device)
    nation = torch.randint(0, NUM_NATIONS, (num_suppliers,), generator=g,
                           device=dev, dtype=torch.int32)
    return nation, torch.ones(num_suppliers, dtype=torch.float32, device=dev)


# --- query pieces -----------------------------------------------------------


def q6_func(chunk):
    return chunk["extendedprice"] * chunk["discount"]


def q6_cond(window):
    lo, hi = window

    def cond(chunk):
        sd, dc = chunk["shipdate"], chunk["discount"]
        return (
            (sd >= lo)
            & (sd < hi)
            & (dc >= 0.02 - 1e-6)
            & (dc <= 0.03 + 1e-6)
            & (chunk["quantity"] == 1.0)
        ).to(torch.float32)

    return cond


def q1_func(chunk):
    """The four Q1 SUM aggregates, stacked [..., 4]."""
    ep, dc, tx = chunk["extendedprice"], chunk["discount"], chunk["tax"]
    return torch.stack(
        [chunk["quantity"], ep, ep * (1 - dc), ep * (1 - dc) * (1 + tx)], dim=-1
    )


def q1_cond(chunk):
    sd = chunk["shipdate"]
    return ((sd >= Q1_WINDOW[0]) & (sd < Q1_WINDOW[1])).to(torch.float32)


def q1_group_small(chunk):
    return chunk["rfls"]


def q1_group_large(chunk):
    return chunk["suppkey"]


def q1_large_scenario(
    rows: int,
    *,
    num_suppliers: int = Q1_LARGE_SUPPLIERS,
    bucket_bits: int = Q1_LARGE_BUCKET_BITS,
    seed: int = 7,
    estimator: str = "single",
    device="cuda",
):
    """Large-domain Q1 group-by: columns + a hash-bucketed group-by GLA.
    Returns ``(cols, gla)``."""
    from repro_torch import gla as _gla  # local: data must not require the engine

    cols = generate_lineitem(rows, num_suppliers=num_suppliers, seed=seed,
                             device=device)
    g = _gla.make_groupby_gla(
        q1_func, q1_cond, q1_group_large, num_groups=num_suppliers,
        bucket_bits=bucket_bits, d_total=float(rows), estimator=estimator,
        num_aggs=4)
    return cols, g


# --- two-table Q3/Q10-class join scenarios ---------------------------------
#
# lineitem ⋈ orders on orderkey, grouped by an orders-side attribute with an
# orders-side date predicate.  The orders dimension is replicated and
# pre-joined in memory (paper §5.4).

NUM_SEGMENTS = 5  # c_mktsegment / o_orderpriority-scale domain
Q3_DATE_CUTOFFS = (430, 2100)  # orders-side o_orderdate window


def orderkey(chunk):
    """The lineitem-side join key l_orderkey."""
    return chunk["orderkey"]


def generate_orders_fk(rows: int, *, num_orders: int | None = None,
                       seed: int = 7, device="cuda") -> torch.Tensor:
    """The foreign key l_orderkey, int32 [rows] in [0, num_orders)
    (default rows // 4); callers add it as ``cols["orderkey"]``."""
    num_orders = num_orders or max(1, rows // 4)
    g, dev = _generator(seed + 101, device)
    return torch.randint(0, num_orders, (rows,), generator=g, device=dev,
                         dtype=torch.int32)


def orders_table(num_orders: int, seed: int = 13, *,
                 date_window=Q3_DATE_CUTOFFS, device="cuda"):
    """Replicated orders dimension: orderkey -> (segment int32, valid
    float32), ``valid`` the orders-side date predicate evaluated once."""
    g, dev = _generator(seed, device)
    segment = torch.randint(0, NUM_SEGMENTS, (num_orders,), generator=g,
                            device=dev, dtype=torch.int32)
    orderdate = torch.randint(0, DAYS, (num_orders,), generator=g, device=dev,
                              dtype=torch.int32)
    lo, hi = date_window
    return segment, ((orderdate >= lo) & (orderdate < hi)).to(torch.float32)


def _join_scenario(rows, func, num_aggs, *, num_orders, seed, estimator,
                   device):
    from repro_torch import gla as _gla  # local: data must not require the engine

    cols = generate_lineitem(rows, seed=seed, device=device)
    cols["orderkey"] = generate_orders_fk(rows, num_orders=num_orders,
                                          seed=seed, device=device)
    dim = orders_table(num_orders or max(1, rows // 4), seed=seed + 7,
                       device=device)
    g = _gla.make_join_groupby_gla(
        func, q1_cond, orderkey, *dim, num_groups=NUM_SEGMENTS,
        d_total=float(rows), estimator=estimator, num_aggs=num_aggs,
        device=device)
    return cols, g, dim


def q3_scenario(rows: int, *, num_orders: int | None = None, seed: int = 7,
                estimator: str = "single", device="cuda"):
    """Q3-class join: SUM(revenue) per order segment, orders date-windowed.
    Returns ``(cols, gla, (segment, valid))``."""
    return _join_scenario(rows, q6_func, 1, num_orders=num_orders, seed=seed,
                          estimator=estimator, device=device)


def q10_scenario(rows: int, *, num_orders: int | None = None, seed: int = 7,
                 estimator: str = "single", device="cuda"):
    """Q10-class join: the four Q1 SUMs per order segment ([G, 4] states).
    Returns ``(cols, gla, (segment, valid))``."""
    return _join_scenario(rows, q1_func, 4, num_orders=num_orders, seed=seed,
                          estimator=estimator, device=device)


def _exact_batches(cols, batch_rows: int, device):
    """Bounded row batches ({name: [n]} with ``_mask``) of a flat columnar
    dict or of a ``ChunkSource``.  A source is read one group of
    ``batch_rows // (P·L)`` chunks at a time, moved to ``device`` (the
    CPU by default), decoded and flattened, so the oracle never holds the
    whole table."""
    from repro_torch.data import encodings as _enc
    from repro_torch.data import source as _source

    if isinstance(cols, _source.ChunkSource):
        P, C, L = cols.spec.P, cols.spec.C, cols.spec.L
        step = max(1, batch_rows // max(1, P * L))
        dev = torch.device("cpu") if device is None else resolve_device(device)
        for lo in range(0, C, step):
            sl = {k: _source.as_tensor(v).to(dev)
                  for k, v in cols.slice_cols(lo, min(C, lo + step)).items()}
            sl = _enc.decode_cols(sl, cols.encodings)
            yield {k: v.reshape(-1, *v.shape[3:]) for k, v in sl.items()}
        return
    n = next(iter(cols.values())).shape[0]
    for lo in range(0, n, batch_rows):
        yield {k: v[lo:lo + batch_rows] for k, v in cols.items()}


def exact_answer(cols, func, cond, group=None, num_groups: int | None = None, *,
                 batch_rows: int = 1 << 24, join_key=None, dim_group=None,
                 dim_valid=None, device=None):
    """Ground truth in float64 — the oracle for every correctness check.

    ``cols`` is a flat columnar dict (``[N]`` tensors, optionally with a
    ``_mask``) or any ``repro_torch.data.source.ChunkSource``, read in
    slice groups of about ``batch_rows`` rows that are decoded and moved
    to ``device`` (CPU by default; a flat dict stays where it is).  The
    per-row values come from the query's own closures (in float32, as the
    engine sees them) and are accumulated in float64 batch by batch.

    Joins: pass ``join_key`` (chunk -> fact-side keys) with the replicated
    ``dim_group``/``dim_valid``; each batch gathers its keys' dimension
    rows, folds ``dim_valid`` into the weight and groups by ``dim_group``,
    as ``gla.make_join_groupby_gla`` does.
    """
    if join_key is not None and (dim_group is None or dim_valid is None):
        raise ValueError("join oracle needs dim_group and dim_valid")
    acc = None
    for chunk in _exact_batches(cols, batch_rows, device):
        vals = func(chunk).to(torch.float64)
        w = cond(chunk).to(torch.float64)
        if "_mask" in chunk:
            w = w * chunk["_mask"].to(torch.float64)
        gid = None if group is None else group(chunk)
        if join_key is not None:
            keys = join_key(chunk).long()
            w = w * dim_valid.to(w.device)[keys].to(torch.float64)
            gid = dim_group.to(w.device)[keys]
        if vals.ndim == 1:
            vals = vals[:, None]
        contrib = vals * w[:, None]
        if gid is None:
            s = contrib.sum(dim=0)
        else:
            s = torch.zeros((num_groups, vals.shape[1]), dtype=torch.float64,
                            device=vals.device)
            s.index_add_(0, gid.long(), contrib)
        acc = s if acc is None else acc + s
    return acc
