"""PF-OLA on PyTorch and CUDA — the port of the ``repro`` JAX package.

The query loop of the paper runs here on an NVIDIA Hopper card: TPC-H
lineitem packed into ``[P, C, L]`` shards, GLAs with the single-estimator
model, ``run_query`` / ``Session`` with per-round Horvitz–Thompson
estimates and Eq. (4) bounds, and stopping rules that end the scan early.
``run_queries`` runs any number of queries (a ``GLABundle``) over one scan,
and ``make_join_groupby_gla`` joins a replicated dimension table (paper
Alg. 4).  Any entry point also takes a chunk source (``data/source.py``):
``NpyMmapSource``, ``EncodedSource`` (dictionary-coded and bit-packed
columns, ``data/encodings.py``) and ``ParquetSource`` (``part-*.parquet``
files of live rows; needs the optional ``pyarrow``) are scanned out of
core, one prefetched round-slice on the card at a time, bitwise as the
resident run.  ``randomize.randomize_distributed`` is the paper's two-stage
randomization of data that arrives already partitioned.  On
``emit="kernel"`` the round-slices go through hand-written CUDA kernels
(``repro_torch.kernels.fused_agg``, and ``kernels.ops`` where the fused
contract cannot be used); on a CPU tensor the same wrappers run their
plain PyTorch versions (``repro_torch.kernels.ref``).

Layout: the JAX package keeps its engine modules under ``repro/core/``.
Here they sit at the package top level (``uda``, ``estimators``, ``gla``,
``scan``, ``engine``, ``session``, ``spec``, ``randomize``) on purpose:
the repository's contract linter (``repro/analysis/contracts.py``) matches
files by path suffix — ``core/scan.py``, ``core/estimators.py``,
``core/session.py`` — and applies JAX-specific rules to them (no ``int()``
in any function of ``scan.py``, ``jnp.maximum`` clamps in
``estimators.py``, a checkpoint manifest in ``session.py``).  A
``repro_torch/core/`` directory would inherit those rules; the flat layout
keeps the module names without the trap.

Failures and checkpoints: ``FaultPolicy`` (and ``repro_torch.fault``'s
``run_with_failures``, ``FailingSource``) applies paper §4.6 to live
sessions, ``Session.pause``/``Session.resume`` checkpoint through
``repro_torch.ckpt`` and resume on another partition count through
``RepartitionedSource``; ``engine.straggler_schedule`` and
``emit="round_masked"`` run heterogeneous partition speeds.

Partitions across processes: ``init_partition_group`` joins a
``torch.distributed`` group (gloo, or NCCL with one card a rank) and every
entry point takes ``mesh=`` the ``PartitionGroup`` it returns — each rank
steps its own partitions, and the results are bitwise the one-process
run's (``repro_torch.sharded``).

Serving: ``OLAService`` (asyncio) and ``SharedScan`` serve many
dynamically arriving ``SlotQuery``s of one ``SlotFamily`` from ONE cyclic
scan; each live bank of slots is a bundle that K1 steps in one launch a
round-slice per 16 slots (``repro_torch.service``; the CLI is ``python -m
repro_torch.serve``).  ``OLAService(mesh=)`` serves across processes: rank
0 takes the arrivals, every other rank runs ``OLAService.follow``.
``compose``/``make_having_gla`` nest the Deep OLA HAVING estimator over a
group-by.

Plan trees: ``QuerySpec`` (and so every entry point) also takes a
``PlanNode`` tree — ``Scan``, ``Filter``, ``Join`` stages under a
``SumAgg``, ``GroupAgg``, ``Having`` or sketch root (``CountDistinct``,
``Quantile``, ``HeavyHitters``) — and lowers it with ``lower_plan`` onto
the GLA constructors, so a one-node tree runs bitwise its flat GLA through
the same kernels.  The sketch GLAs (``repro_torch.sketch``) run on the scan
paths; ``monotone_envelope`` turns per-round bounds into non-widening ones,
and ``repro_torch.metrics`` estimates a mean per-example loss on line.

Entry points take ``device=`` and default to ``"cuda"``; with no card they
raise unless the caller asks for ``"cpu"``.  The package imports ``torch``
and ``numpy`` only — never ``jax`` and nothing of ``repro`` (nor
``msgpack`` or ``zstandard``).
"""
from repro_torch import ckpt, fault, metrics, sharded, sketch
from repro_torch.data.encodings import BitPackedEncoding, DictEncoding
from repro_torch.data.source import (
    ChunkSource,
    EncodedSource,
    InMemorySource,
    NpyMmapSource,
    ParquetSource,
    PartitionLostError,
    PartitionRangeSource,
    RepartitionedSource,
    as_source,
    repartition,
)
from repro_torch.engine import (
    QueryResult,
    run_queries,
    run_query,
    straggler_schedule,
)
from repro_torch.estimators import monotone_envelope
from repro_torch.gla import (
    GLABundle,
    SlotFamily,
    SlotQuery,
    compose,
    debucket,
    hash_bucket,
    make_groupby_gla,
    make_having_gla,
    make_join_groupby_gla,
    make_sum_gla,
)
from repro_torch.session import (
    FaultPolicy,
    RoundProgress,
    Session,
    abs_width,
    all_of,
    any_of,
    budget,
    rel_width,
)
from repro_torch.service import OLAService, SharedScan
from repro_torch.sharded import PartitionGroup, init_partition_group
from repro_torch.sketch import (
    make_count_distinct_gla,
    make_heavy_hitters_gla,
    make_quantile_gla,
)
from repro_torch.spec import (
    CountDistinct,
    Filter,
    GroupAgg,
    Having,
    HeavyHitters,
    Join,
    PlanNode,
    Quantile,
    QuerySpec,
    Scan,
    SumAgg,
    lower_plan,
)
from repro_torch.uda import GLA, Estimate, FusedSpec, ProbeTable

__all__ = [
    "BitPackedEncoding",
    "ChunkSource",
    "CountDistinct",
    "DictEncoding",
    "EncodedSource",
    "Estimate",
    "FaultPolicy",
    "Filter",
    "FusedSpec",
    "GLA",
    "GLABundle",
    "GroupAgg",
    "Having",
    "HeavyHitters",
    "InMemorySource",
    "Join",
    "NpyMmapSource",
    "ParquetSource",
    "OLAService",
    "PartitionGroup",
    "PartitionLostError",
    "PartitionRangeSource",
    "PlanNode",
    "ProbeTable",
    "Quantile",
    "QueryResult",
    "QuerySpec",
    "RepartitionedSource",
    "RoundProgress",
    "Scan",
    "Session",
    "SharedScan",
    "SlotFamily",
    "SlotQuery",
    "SumAgg",
    "abs_width",
    "all_of",
    "any_of",
    "as_source",
    "budget",
    "ckpt",
    "compose",
    "debucket",
    "fault",
    "hash_bucket",
    "init_partition_group",
    "lower_plan",
    "make_count_distinct_gla",
    "make_groupby_gla",
    "make_having_gla",
    "make_heavy_hitters_gla",
    "make_join_groupby_gla",
    "make_quantile_gla",
    "make_sum_gla",
    "metrics",
    "monotone_envelope",
    "rel_width",
    "repartition",
    "run_queries",
    "run_query",
    "sharded",
    "sketch",
    "straggler_schedule",
]
