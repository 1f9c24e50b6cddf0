"""Partitions across processes — port of ``repro/dist/shard_engine.py``.

The reference places one partition per device under ``jax.shard_map`` from a
single controller, merges with one ``psum`` (the paper's aggregation tree),
truncates to the ``pmin`` progress under ``mode="sync"`` and, with
``sync_cost_model=True``, pays one coordination ``psum`` per chunk.  The port
runs SPMD over ``torch.distributed``: W processes (ranks), usually one per
card, each calling the same entry point (``run_query``, ``run_queries``,
``Session``, ``Session.resume``, ``fault.run_with_failures``, all with
``mesh=`` a :class:`PartitionGroup`) with the same plan.  Rank k owns the
contiguous partitions [k·P/W, (k+1)·P/W) — ``P % W == 0``, refused before any
work otherwise — and steps them through the same per-partition code as one
process (K1, K2 and the scan drivers over ``[P/W, C, L]``).  Every rank holds
the whole ``[P, R+1]`` schedule and liveness weights and returns the whole
query's result.

Merging is gather-then-reduce.  An all-reduce SUM associates in the
backend's order, so it would not be bitwise the one-process ``.sum(dim=0)``
over ``[P, ...]`` (``engine._weighted_sum``).  The states are small (at most
G × A floats a partition), so every rank's per-partition states are
all-gathered in rank order — one collective of their raw bytes — into
``[P, ...]``, and every rank applies the one-process reduction
(``engine._merge_over_partitions``/``_merge_round``/``_merge_result``) to
them, liveness weights included.  Finals, every round's merged state and
every estimate are then bitwise the one-process run's, whenever each
partition's states are (the kernels' per-partition results do not depend on
the launch's P: K1 and K2 fold each partition's chunks in order).  Each
session step leaves every rank holding all partitions' round views, so the
final merge needs no collective of its own (the reference's
``session_final_sharded``).

Under ``mode="sync"`` the minimum-progress truncation is a host computation
over the whole schedule; with ``sync_cost_model=True`` every chunk step of
the scan pays a real one-element ``all_reduce``, as the reference's per-chunk
``psum``.

Ranks must not disagree, or some wait in a collective that others never
enter.  So: a session step runs this rank's read and kernels, then every
rank exchanges its outcome — failed or not, and the partitions its source
reported lost (``PartitionLostError``) — before the round's merge
(:func:`checked`), so every rank records the same loss at the same round,
and one rank's exception makes every rank raise at once; a stopping rule is
evaluated by rank 0 and its decision broadcast (:meth:`PartitionGroup.decide`),
so ``budget(max_seconds=...)`` stops every rank at the same round; and the
group's timeout bounds any wait that remains.  Collectives run on tensors on
the group's device (gloo stages CUDA tensors through the host itself).
"""
from __future__ import annotations

import time
from datetime import timedelta
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import engine as EN
from repro_torch.data import source as DS
from repro_torch.uda import GLA, tree_map

Pytree = Any

_OK, _LOST, _FAILED = 0, 1, 2  # a rank's outcome, as :func:`checked` exchanges it


class PartitionGroup:
    """The port's mesh: a ``torch.distributed`` process group whose ranks
    each own a contiguous range of a layout's partitions.

    Rank k of W owns partitions :meth:`bounds`\\ ``(P)`` = [k·P/W, (k+1)·P/W)
    of a P-partition layout; ``device`` is where its partitions, states and
    every collective's buffers live.  Built by :func:`init_partition_group`
    (or around an existing ``group``, and then without the ``store`` that
    ``service.OLAService(mesh=)`` needs).  Collectives record the host seconds
    they take and the bytes they bring in (:meth:`stats`)."""

    def __init__(self, group=None, *, device, store=None, timeout: float = 300.0):
        self.group = group
        #: the key-value store the ranks met through (None when built around
        #: a group whose store is unknown): the channel of a service over
        #: this group, from rank 0 to the others
        self.store = store
        self.timeout = timeout  # seconds a collective waits before it fails
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL group runs on a CUDA device, not {self.device}")
        self._root = 0 if group is None else dist.get_global_rank(group, 0)
        self._prog = None  # the sync cost model's progress counter
        self.reset_stats()

    def bounds(self, P: int):
        """This rank's partitions [lo, hi) of a P-partition layout."""
        if P % self.world:
            raise ValueError(
                f"P={P} partitions do not split evenly over {self.world} ranks: "
                "the partition count must be a multiple of the group's size")
        n = P // self.world
        return self.rank * n, (self.rank + 1) * n

    # -- collectives ---------------------------------------------------------

    def _all_gather(self, buf: torch.Tensor) -> list:
        out = [torch.empty_like(buf) for _ in range(self.world)]
        t0 = time.perf_counter()
        dist.all_gather(out, buf, group=self.group)
        self._seconds += time.perf_counter() - t0
        self._bytes += buf.numel() * buf.element_size() * self.world
        self._calls += 1
        return out

    def gather(self, tree: Pytree) -> Pytree:
        """Every rank's ``tree`` — leaves [n, ...], the same shapes and
        dtypes on every rank — concatenated along dim 0 in rank order,
        [W·n, ...], on every rank.  One all-gather of the leaves' raw bytes,
        so they come back bit for bit (``None`` leaves stay ``None``)."""
        leaves = []
        tree_map(leaves.append, tree)
        if not leaves:
            return tree
        parts, sizes = [], []
        for x in leaves:
            flat = x.to(self.device).reshape(-1)
            if flat.stride(0) != 1:  # a one-element view keeps its parent's stride
                flat = flat.clone(memory_format=torch.contiguous_format)
            b = flat.view(torch.uint8)
            sizes.append(b.numel())
            pad = -b.numel() % 8  # every leaf starts 8-byte aligned
            parts.append(torch.cat([b, b.new_zeros(pad)]) if pad else b)
        ranks = self._all_gather(torch.cat(parts))
        out, off = [], 0
        for x, n, part in zip(leaves, sizes, parts):
            rows = [r[off:off + n].view(x.dtype).reshape(x.shape) for r in ranks]
            out.append(torch.cat(rows, dim=0))
            off += part.numel()
        it = iter(out)
        return tree_map(lambda _: next(it), tree)

    def exchange(self, code: int, lost, P: int):
        """Every rank's outcome code and lost partitions (of P), in rank
        order: ([W] codes, sorted union of the lost partitions)."""
        head = torch.zeros(1 + P, dtype=torch.uint8)
        head[0] = code
        head[1 + torch.as_tensor(sorted(lost), dtype=torch.int64)] = 1
        rows = torch.stack(self._all_gather(head.to(self.device))).cpu()
        lost_all = torch.nonzero(rows[:, 1:].amax(dim=0)).reshape(-1).tolist()
        return rows[:, 0].tolist(), lost_all

    def post(self, key: str, payload: bytes) -> None:
        """``payload`` under ``key`` in the group's store, for the other
        ranks to :meth:`fetch` (timed into :meth:`stats`)."""
        t0 = time.perf_counter()
        self.store.set(key, payload)
        self._seconds += time.perf_counter() - t0
        self._bytes += len(payload)
        self._calls += 1

    def fetch(self, key: str) -> bytes:
        """What another rank posted under ``key`` (timed into :meth:`stats`)."""
        t0 = time.perf_counter()
        payload = self.store.get(key)
        self._seconds += time.perf_counter() - t0
        self._bytes += len(payload)
        self._calls += 1
        return payload

    def decide(self, fn) -> bool:
        """``fn()`` evaluated on rank 0 alone, its answer broadcast to every
        rank (an exception there raises on every rank)."""
        code, err = _OK, None
        if self.rank == 0:
            try:
                code = 1 if fn() else 0
            except Exception as e:  # every rank must hear of it, then raise
                code, err = _FAILED, e
        t = torch.tensor([code], dtype=torch.uint8, device=self.device)
        t0 = time.perf_counter()
        dist.broadcast(t, src=self._root, group=self.group)
        self._seconds += time.perf_counter() - t0
        self._calls += 1
        code = int(t.item())
        if code == _FAILED:
            if err is not None:
                raise err
            raise RuntimeError("rank 0 of the partition group failed evaluating "
                               "the stopping rule")
        return bool(code)

    def chunk_barrier(self) -> None:
        """One chunk step's coordination under the sync cost model: a
        one-element ``all_reduce`` of the progress counter, the reference's
        ``psum(prog + 1) / P``."""
        if self._prog is None:
            self._prog = torch.zeros(1, device=self.device)
        prog = self._prog
        prog += 1.0
        t0 = time.perf_counter()
        dist.all_reduce(prog, op=dist.ReduceOp.SUM, group=self.group)
        self._seconds += time.perf_counter() - t0
        self._calls += 1
        prog /= self.world

    # -- instrumentation -----------------------------------------------------

    def reset_stats(self) -> None:
        self._seconds, self._bytes, self._calls = 0.0, 0, 0

    def stats(self) -> dict:
        """Host seconds inside collectives and store records, bytes brought
        in by gathers (every rank's share, this rank's included) and records
        posted or fetched, and their calls, since the last
        :meth:`reset_stats`."""
        return {"seconds": self._seconds, "bytes": self._bytes, "calls": self._calls}

    def close(self) -> None:
        """Leave the process group (the default group when built by
        :func:`init_partition_group`)."""
        dist.destroy_process_group(self.group)


def init_partition_group(backend: str, init_method: str, rank: int, world: int,
                         device, timeout: float = 300.0) -> PartitionGroup:
    """Join a W-rank process group and return it as a :class:`PartitionGroup`
    on ``device`` — the part ``launch/mesh.py`` plays in the reference.

    ``init_method`` is where the ranks meet (``file://<path>`` for a file
    store, ``tcp://localhost:<port>``); nothing here discovers a cluster.
    The store the ranks meet through is kept (:attr:`PartitionGroup.store`).
    ``backend`` is ``"gloo"`` (CPU tensors, or CUDA tensors staged through
    the host: several ranks may share one card) or ``"nccl"`` (one card per
    rank).  Every collective gives up after ``timeout`` seconds."""
    dev = torch.device(device)
    wait = timedelta(seconds=timeout)
    store, rank, world = next(dist.rendezvous(init_method, rank, world, timeout=wait))
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=wait)
    return PartitionGroup(device=dev, store=store, timeout=timeout)


def checked(mesh: PartitionGroup, P: int, fn):
    """Run ``fn() -> (out, lost)`` on this rank, then agree with every rank
    before anyone goes on: returns ``(out, every rank's lost partitions)``.

    When any rank raised, every rank raises: the failing rank its own
    exception, a rank whose source lost partitions without a policy to
    survive it a ``PartitionLostError`` naming every rank's losses, and the
    others a ``RuntimeError`` naming the failed ranks — at once, not after
    the group's timeout."""
    out, err, code, lost = None, None, _OK, ()
    try:
        out, lost = fn()
    except DS.PartitionLostError as e:
        err, code, lost = e, _LOST, e.partitions
    except Exception as e:  # every rank must hear of it, then it is re-raised
        err, code = e, _FAILED
    codes, lost_all = mesh.exchange(code, lost, P)
    if err is not None:
        raise err
    failed = [k for k, c in enumerate(codes) if c == _FAILED]
    if failed:
        raise RuntimeError(f"ranks {failed} of the partition group failed; "
                           f"rank {mesh.rank} stops with them")
    if any(c == _LOST for c in codes):
        raise DS.PartitionLostError(lost_all)
    return out, lost_all


# ---------------------------------------------------------------------------
# placement: this rank's rows of a whole layout
# ---------------------------------------------------------------------------

def device_put_slice(cols: dict, *, mesh: PartitionGroup) -> dict:
    """This rank's rows of a whole ``[P, ...]`` columnar batch (host arrays
    or tensors) on its device: ``[P/W, ...]`` (the reference places each
    partition's block on its own device)."""
    lo, hi = mesh.bounds(int(cols["_mask"].shape[0]))
    return {k: DS.as_tensor(v[lo:hi]).to(mesh.device) for k, v in cols.items()}


def device_put_carry(states: Pytree, *, mesh: PartitionGroup) -> Pytree:
    """This rank's rows of a whole ``[P, ...]`` session carry on its device
    — resumed carries arrive whole from the checkpoint, possibly merged or
    split to another partition count (``scan.merge_carries`` /
    ``split_carries``) first."""
    def put(x):
        lo, hi = mesh.bounds(x.shape[0])
        return x[lo:hi].to(mesh.device)

    return tree_map(put, states)


class RankView(NamedTuple):
    """One rank's share of a layout: its source and the whole layout's
    spec."""

    source: DS.ChunkSource  # [P/W, C, L]
    spec: DS.ChunkSpec  # the whole layout's, [P, C, L]


def rank_view(mesh: PartitionGroup, data) -> RankView:
    """This rank's share of ``data``: a dict is this rank's resident block
    ``[P/W, C, L]`` of a ``W·P/W``-partition layout; a source is the whole
    layout, of which this rank reads its own partitions (a resident one is
    copied to the device row range by row range, a streaming one read
    through a ``PartitionRangeSource``).  Every rank's share must have the
    same shape: checked across the group."""
    if isinstance(data, RankView):
        view = data
    elif isinstance(data, dict):
        src = DS.InMemorySource(data)
        view = RankView(src, src.spec._replace(P=src.spec.P * mesh.world))
    else:
        whole = DS.as_source(data)
        lo, hi = mesh.bounds(whole.spec.P)
        src = (DS.InMemorySource(device_put_slice(whole.shards, mesh=mesh))
               if whole.resident else DS.PartitionRangeSource(whole, lo, hi))
        view = RankView(src, whole.spec)
    s = view.source.spec
    shapes = mesh.gather(torch.tensor([[s.P, s.C, s.L, len(s.columns)]], dtype=torch.int64))
    if not bool((shapes == shapes[0]).all()):
        raise ValueError(f"the ranks' shares of the data differ in shape "
                         f"([P, C, L, columns] per rank: {shapes.tolist()})")
    return view


def repartition_view(view: RankView, mesh: PartitionGroup, partitions: int) -> RankView:
    """``view`` as this rank's share of the layout repartitioned to
    ``partitions`` (``data.source.repartition``).  With W dividing both
    partition counts a new partition's rows come from old partitions of
    the same rank, so each rank repartitions its own share."""
    P = view.spec.P
    if partitions == P:
        return view
    lo, hi = mesh.bounds(partitions)
    local = DS.repartition(view.source, hi - lo)
    return RankView(local, view.spec._replace(P=int(partitions), C=local.spec.C))


def fingerprint(mesh: PartitionGroup, source: DS.ChunkSource, spec: DS.ChunkSpec) -> str:
    """The whole layout's content fingerprint (``ChunkSource.fingerprint``
    of a source over all P partitions, ``spec``), from this rank's share
    ``source``: each rank's mask sums and samples, gathered in partition
    order — no rank reads another's partitions."""
    mask_sums, samples = DS.fingerprint_parts(source)
    names = [sorted(s) for s in samples]
    parts = [torch.from_numpy(mask_sums)] + [
        torch.from_numpy(s[k]) for s, ks in zip(samples, names) for k in ks]
    full = [p.cpu().numpy() for p in mesh.gather(parts)]
    it = iter(full[1:])
    return DS.content_fingerprint(
        spec, full[0], [{k: next(it) for k in ks} for ks in names])


# ---------------------------------------------------------------------------
# the whole-scan program and one session round
# ---------------------------------------------------------------------------

def run_sharded(gla: GLA, shards: dict, sched: np.ndarray, alive, *,
                mesh: PartitionGroup, mode: str, emit: str, lanes: int,
                snapshots: bool, confidence: float, all_alive: bool,
                sync_cost_model: bool = True) -> EN.QueryResult:
    """Same math as ``engine._run_vmapped`` over this rank's partitions
    ``shards`` ([P/W, C, L] of the P rows of ``sched``): the rank's final
    and round states and |D_i| are gathered in partition order and merged
    as one process merges them."""
    if not gla.merge_is_additive:
        raise ValueError("sharded path requires additive merges")
    if emit == "kernel" and mode == "sync":
        # No silent downgrade: with sync_cost_model the per-chunk
        # coordination scan replaces the scan entirely (the kernel dispatch
        # would never run), and the group-by kernel contract has no prefix
        # states for the min-progress truncation even without it.
        if sync_cost_model:
            raise ValueError(
                "emit='kernel' is incompatible with mode='sync' + "
                "sync_cost_model=True: the per-chunk coordination scan "
                "bypasses the kernel dispatch — use emit='chunk', or pass "
                "sync_cost_model=False (scalar-SumState GLAs only)")
        if gla.kernel_num_groups is not None or gla.members:
            raise ValueError(
                "group-by/bundled emit='kernel' emits round states only; "
                "mode='sync' needs prefix states for the min-progress "
                "truncation — use emit='chunk' or mode='async'")
    if emit == "round" and mode == "sync" and not sync_cost_model:
        # scan_rounds has no prefix states, so the truncation would be
        # skipped and async round states labelled as synchronized estimates
        raise ValueError(
            "emit='round' emits round states only; mode='sync' needs prefix "
            "states for the min-progress truncation — use emit='chunk'")
    P = sched.shape[0]
    lo, _ = mesh.bounds(P)
    # the synchronized competitor pays one coordination per chunk: its scan
    # is the prefix scan whatever the emission discipline
    coordinate = mode == "sync" and sync_cost_model

    def local():
        return EN._scan_states(
            gla, shards, sched, lo=lo, mode=mode,
            emit="chunk" if coordinate else emit, lanes=lanes, snapshots=snapshots,
            on_chunk=mesh.chunk_barrier if coordinate else None), ()

    (finals, round_states, d_local), _ = checked(mesh, P, local)
    finals, round_states, d_local = mesh.gather((finals, round_states, d_local))
    return EN._merge_result(gla, finals, round_states, d_local, alive,
                            rounds=sched.shape[1] - 1, snapshots=snapshots,
                            confidence=confidence, all_alive=all_alive)


def session_step_sharded(gla: GLA, views: Pytree, w_r: torch.Tensor,
                         d_local: torch.Tensor, d_total: torch.Tensor, *,
                         mesh: PartitionGroup, confidence: float, all_alive: bool):
    """Merge one session round: this rank's round views (``scan.round_step``
    over its partitions) gathered with every rank's into [P, ...], then
    the one-process merge (``engine._merge_round``) under the round's
    weights ``w_r`` [P] and the whole layout's ``d_local`` [P].  Returns
    (every partition's views, merged state, Estimate-or-None)."""
    views = mesh.gather(views)
    merged, est = EN._merge_round(gla, views, w_r, d_local, d_total, confidence,
                                  all_alive)
    return views, merged, est


def resolve_device(mesh: PartitionGroup, device: Optional[Any]) -> torch.device:
    """The device a session under ``mesh`` runs on: the group's; a
    different ``device`` is refused (nothing moves to the CPU on its own)."""
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {str(device)!r} differs from the partition "
                         f"group's {str(mesh.device)!r}")
    return mesh.device

