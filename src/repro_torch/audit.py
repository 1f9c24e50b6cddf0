"""Plan invariant auditor — port of ``repro/analysis/audit.py``.

PF-OLA's "virtually no overhead" claim (paper §5) rests on structural
invariants of the program a plan runs: one pass over the chunk stream, an
O(slice) device footprint per incremental step, one kernel dispatch per
round-slice, a fixed number of collectives per round, no state carried
below float32, no rebuild as users attach.  This module names them and
certifies any plan before it runs::

    from repro_torch import engine
    report = engine.audit_plan(q, shards, rounds=8, emit="chunk")
    report.raise_for_failures()

or at session construction::

    Session(QuerySpec(q, rounds=8), shards, audit=True)  # raises AuditError

**Where the reference scans no data, the port scans one round-slice and
throws the result away.**  The reference lowers its programs from shapes
and reads their compiled text; the port compiles no program, so each check
reads a counter that the port keeps exactly, around one *dry step*: the
plan's first round-slice ``[sched[0, 0], sched[0, 1])``, read as
``Session`` reads it (without a prefetcher), advanced from a throwaway
initial carry by ``scan.round_step`` on the path that
``session.session_path`` picks for the session, and, under a mesh, merged
as a session round is (``sharded.checked``, then
``sharded.session_step_sharded``).  The counters are ``scan.CHUNK_STEPS``
(chunks folded), ``kernels._runtime.DISPATCHES`` (kernel dispatches, on the
card and on the CPU's plain route alike), the bytes of the tensors the step
is handed, the card's peak allocated bytes and the group's
``stats()["calls"]``.  ``LAUNCHES``, ``DISPATCHES``, ``CHUNK_STEPS`` and the
group's stats are put back as they were before the audit, so a caller's
exact counts still hold; on the card the audit resets the device's
peak-memory statistics.  A ``fault.FailingSource`` is read through its
inner source: a dry read must not change what the session later sees.  The
dry step runs on the plan's device ("cuda" unless asked): the audit never
moves a plan to the CPU, and a dry step that fails raises.  Under a mesh
every rank audits together, as every rank constructs its session.

The catalog (check names accepted by ``checks=``):

  ``one_chunk_pass``            the dry step folds each chunk of its
                                slice once: ``CHUNK_STEPS`` equals the slice
                                width, however many queries ride the scan.
  ``o_slice_footprint``         the bytes the dry step is handed (numel ×
                                element size of every tensor: a resident
                                slice is a view) lie between one live
                                column and one logical slice plus the
                                carry, and below the dataset's; on the card
                                the step's peak allocated bytes stay within
                                :data:`PEAK_SLICES` logical slices.
  ``single_kernel_dispatch``    a legacy kernel plan (K3 ``group_agg``, K4
                                ``shard_chunk_partials``) dispatches its
                                kernel once per round-slice.
  ``fused_single_dispatch``     a fused plan dispatches K1
                                (``fused_round_step/{scalar,group,bundle}``)
                                once per round-slice and nothing else but
                                the decode of an encoded source.
  ``bytes_moved``               an encoded source streams at most 0.95 of
                                the logical bytes a round-slice.
  ``one_collective_per_round``  a partition group's round takes
                                :data:`ROUND_COLLECTIVES` collective calls,
                                whatever the slice width.
  ``dtype_discipline``          no floating leaf of the carry, states,
                                views, merged state or estimate below
                                float32.
  ``no_recompile_across_rounds``  always ``skip``: the port compiles no
                                step program (kept in :data:`ALL_CHECKS`).
  ``bounded_compiles_under_churn``  (:func:`audit_service`) a churn
                                workload on a ``service.SharedScan`` builds
                                at most one step plan per (bank, capacity)
                                stepped (``SharedScan.compile_budget``).

Differences from the reference, each for a reason of the port:

  * ``no_recompile_across_rounds`` is a skip where the reference passes:
    nothing is compiled, so there is no cache to watch.
  * ``one_chunk_pass`` reads the dry step only; the reference's second
    reading, of the fused whole-scan program, is a skip part (the audit
    does not run the whole scan), so a plan that cannot step (sync mode,
    a non-uniform schedule) skips where the reference passes.
  * ``single_kernel_dispatch`` expects one dispatch per round-slice for
    all P partitions, where the reference expects P (the port launches
    once for every partition), and it counts on any device, where the
    reference counts only in interpret mode and skips 1-chunk slices.
  * ``fused_single_dispatch``: the decode of an encoded source is a
    ``pf_decode`` launch of its own ahead of K1 (``kernels/decode.py``),
    where the reference decodes inside its one ``pallas_call``; a bundle
    of more than 16 members takes one K1 launch per 16.
  * ``o_slice_footprint`` holds the handed bytes to one slice plus the
    carry, exactly (the reference allows 1.5 slices and 1 MiB), and below
    the dataset; the reference's "below an eighth of a dataset of 8 slices
    or more" does not carry over, since the step is handed every column of
    its slice (XLA drops the parameters a program does not read).  It adds
    the card's peak.
  * ``one_collective_per_round`` counts calls (an all-gather each), where
    the reference counts all-reduce ops against the merged state's leaves.
  * ``bounded_compiles_under_churn`` counts step plans
    (``service.serve_step_cache_sizes``) for jit-cache entries.

Checks report ``pass`` / ``fail`` / ``skip``: a skip means the invariant
does not apply to the plan and carries the reason, never a pass.
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import engine as EN
from repro_torch import fault as FT
from repro_torch import scan as SC
from repro_torch import session as SN
from repro_torch import sharded as SH
from repro_torch import spec as QS
from repro_torch._device import resolve_device
from repro_torch.data import source as DS
from repro_torch.kernels import _runtime as RT
from repro_torch.kernels import decode as KD
from repro_torch.kernels import fused_agg as FK
from repro_torch.uda import tree_leaves

#: the card's peak allocated bytes over a dry step, in logical round-slices:
#: the bound ``chip_smoke.py`` holds streamed sessions to
PEAK_SLICES = 4
#: collective calls of one session round of a partition group: the
#: outcome exchange of ``sharded.checked`` and the views' gather of
#: ``sharded.session_step_sharded`` (each one all-gather); a stopping rule
#: adds rank 0's decision, which the dry step does not take
ROUND_COLLECTIVES = 2


class AuditError(RuntimeError):
    """Raised by :meth:`AuditReport.raise_for_failures` when any check failed."""


@dataclass(frozen=True)
class CheckResult:
    """Outcome of one named invariant check.

    ``status`` is ``"pass"``, ``"fail"`` or ``"skip"``; ``detail`` is a
    sentence (the skip reason, or what was measured); ``data`` carries the
    measured quantities for benchmarks and tests to consume.
    """

    name: str
    status: str
    detail: str = ""
    data: Dict[str, Any] = field(default_factory=dict)

    @property
    def passed(self) -> bool:
        return self.status == "pass"

    @property
    def failed(self) -> bool:
        return self.status == "fail"

    @property
    def skipped(self) -> bool:
        return self.status == "skip"

    def __str__(self) -> str:
        return f"[{self.status:>4}] {self.name}: {self.detail}"


@dataclass(frozen=True)
class AuditReport:
    """Structured result of :func:`audit_plan` over one plan."""

    plan: Dict[str, Any]
    results: Tuple[CheckResult, ...]

    @property
    def ok(self) -> bool:
        """True when no check failed (skips do not count against a plan)."""
        return not self.failures

    @property
    def failures(self) -> Tuple[CheckResult, ...]:
        return tuple(r for r in self.results if r.failed)

    def result(self, name: str) -> CheckResult:
        for r in self.results:
            if r.name == name:
                return r
        raise KeyError(f"no check named {name!r} in this report "
                       f"(ran: {[r.name for r in self.results]})")

    def raise_for_failures(self) -> None:
        if self.failures:
            lines = [f"plan {self.plan} failed "
                     f"{len(self.failures)} invariant check(s):"]
            lines += [f"  {r}" for r in self.failures]
            raise AuditError("\n".join(lines))

    def summary(self) -> str:
        head = (f"audit {self.plan.get('gla')} [{self.plan.get('engine')}, "
                f"emit={self.plan.get('emit')}]: "
                f"{'OK' if self.ok else 'FAIL'}")
        return "\n".join([head, *(f"  {r}" for r in self.results)])


# ---------------------------------------------------------------------------
# the reusable checks: pure functions over exact counts
# ---------------------------------------------------------------------------

def _loc(where: str) -> str:
    return f" ({where})" if where else ""


def check_one_chunk_pass(chunk_steps: int, *, width: int, expected: int = 1,
                         where: str = "") -> CheckResult:
    """Each chunk of a ``width``-chunk round-slice folded ``expected``
    times: ``chunk_steps`` (``scan.CHUNK_STEPS`` over the step) equals
    ``expected · width``."""
    data = {"chunk_steps": chunk_steps, "width": width, "expected": expected * width}
    if chunk_steps == expected * width:
        return CheckResult("one_chunk_pass", "pass",
                           f"{chunk_steps} chunk step(s) for a {width}-chunk "
                           f"slice{_loc(where)}", data)
    return CheckResult(
        "one_chunk_pass", "fail",
        f"expected {expected * width} chunk step(s) for a {width}-chunk slice, "
        f"counted {chunk_steps}{_loc(where)} — the step re-scans (or never "
        "scans) the chunk stream", data)


def check_slice_footprint(handed_bytes: int, *, slice_bytes: int, carry_bytes: int,
                          floor_bytes: int, dataset_bytes: Optional[int] = None,
                          peak_bytes: Optional[int] = None,
                          where: str = "") -> CheckResult:
    """The bytes a step is handed are O(slice), not O(data).

    ``floor_bytes`` (one live column of the slice) guards against the count
    degrading to ~0, which would make the ceiling vacuous.  The ceiling is
    one logical slice plus the carry.  When the dataset is larger than one
    slice the step must be handed less than the dataset.  ``peak_bytes`` (the card's allocation above the baseline,
    None where not measured) must stay within :data:`PEAK_SLICES` slices.
    """
    ceil = slice_bytes + carry_bytes
    peak_limit = PEAK_SLICES * slice_bytes
    data = {"handed_bytes": handed_bytes, "slice_bytes": slice_bytes,
            "carry_bytes": carry_bytes, "floor_bytes": floor_bytes,
            "ceiling_bytes": ceil, "dataset_bytes": dataset_bytes,
            "peak_bytes": peak_bytes, "peak_limit_bytes": peak_limit}
    loc = _loc(where)
    if handed_bytes < floor_bytes:
        return CheckResult(
            "o_slice_footprint", "fail",
            f"step handed {handed_bytes}B, below one live column "
            f"({floor_bytes}B){loc} — the count is no longer reading the "
            "step's inputs", data)
    if handed_bytes > ceil:
        return CheckResult(
            "o_slice_footprint", "fail",
            f"step handed {handed_bytes}B, expected O(slice) <= "
            f"{slice_bytes}B + {carry_bytes}B of carry{loc}", data)
    if (dataset_bytes is not None and dataset_bytes > slice_bytes
            and handed_bytes >= dataset_bytes):
        return CheckResult(
            "o_slice_footprint", "fail",
            f"step handed {handed_bytes}B of a {dataset_bytes}B dataset{loc} "
            "— the scan is not out-of-core", data)
    if peak_bytes is not None and peak_bytes > peak_limit:
        return CheckResult(
            "o_slice_footprint", "fail",
            f"step peaked at {peak_bytes}B above its baseline on the card, "
            f"past {PEAK_SLICES} slices ({peak_limit}B){loc}", data)
    peak = "" if peak_bytes is None else f"; card peak {peak_bytes}B <= {peak_limit}B"
    return CheckResult(
        "o_slice_footprint", "pass",
        f"step handed {handed_bytes}B within [{floor_bytes}, {ceil}]B{peak}{loc}",
        data)


def check_dispatches(name: str, dispatches: Dict[str, int], *,
                     expected: Dict[str, int], where: str = "") -> CheckResult:
    """Exactly ``expected`` dispatches per kernel, and none of any other
    kernel (``dispatches``: the step's ``DISPATCHES`` delta)."""
    got = {k: n for k, n in dispatches.items() if n}
    want = {k: n for k, n in expected.items() if n}
    data = {"dispatches": got, "expected": want}
    if got == want:
        return CheckResult(name, "pass", f"dispatches {got}{_loc(where)}", data)
    return CheckResult(
        name, "fail",
        f"dispatched {got}, expected {want}{_loc(where)} — missing, duplicated "
        "or extra kernel dispatches", data)


def check_collectives(calls: int, *, expected: int = ROUND_COLLECTIVES, width: int,
                      where: str = "") -> CheckResult:
    """A round of a partition group takes ``expected`` collective calls,
    whatever its ``width`` (none of them per chunk)."""
    data = {"calls": calls, "expected": expected, "width": width}
    if calls == expected:
        return CheckResult(
            "one_collective_per_round", "pass",
            f"{calls} collective call(s) for a {width}-chunk round{_loc(where)}",
            data)
    if calls == 0:
        detail = (f"no collective in the round{_loc(where)} — the merge was "
                  "lost (states would stay per-rank)")
    else:
        detail = (f"{calls} collective calls for a {width}-chunk round, expected "
                  f"{expected}{_loc(where)} — a collective per chunk or a "
                  "duplicated merge")
    return CheckResult("one_collective_per_round", "fail", detail, data)


def check_dtype_discipline(trees_by_role: Dict[str, Any]) -> CheckResult:
    """No floating leaf of the estimator state or estimate below float32.

    ``trees_by_role`` maps a role ("init", "states", "merged", ...) to a
    tree of tensors (or of ``torch.dtype`` leaves)."""
    narrow, n = [], 0
    for role, tree in trees_by_role.items():
        if tree is None:
            continue
        for i, leaf in enumerate(tree_leaves(tree)):
            n += 1
            dt = leaf if isinstance(leaf, torch.dtype) else leaf.dtype
            if dt.is_floating_point and torch.finfo(dt).bits < 32:
                narrow.append(f"{role}[{i}]: {dt}")
    if narrow:
        return CheckResult(
            "dtype_discipline", "fail",
            "estimator state carried below float32: " + ", ".join(narrow),
            {"narrow_leaves": narrow})
    return CheckResult("dtype_discipline", "pass",
                       f"{n} state/estimate leaves all >= float32",
                       {"leaves_checked": n})


# ---------------------------------------------------------------------------
# the plan and its dry step
# ---------------------------------------------------------------------------

STATIC_CHECKS: Tuple[str, ...] = (
    "one_chunk_pass", "o_slice_footprint", "single_kernel_dispatch",
    "fused_single_dispatch", "bytes_moved",
    "one_collective_per_round", "dtype_discipline")
ALL_CHECKS: Tuple[str, ...] = (*STATIC_CHECKS, "no_recompile_across_rounds")


def _nbytes(tree) -> int:
    """numel × element size of every tensor leaf (a view counts as the
    tensor it shows, not its storage)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _dry_source(src: DS.ChunkSource):
    """(the source a dry read may touch, None) — a ``FailingSource`` (alone
    or as a rank's partition range) read through its inner source — or
    (None, the reason) when a ``FailingSource`` lies deeper in a view."""
    if isinstance(src, FT.FailingSource):
        return src.inner, None
    if isinstance(src, DS.PartitionRangeSource) and isinstance(src.inner, FT.FailingSource):
        return DS.PartitionRangeSource(src.inner.inner, src.lo, src.hi), None
    inner = getattr(src, "inner", None)
    while inner is not None:
        if isinstance(inner, FT.FailingSource):
            return None, ("a FailingSource under a view: a dry read would "
                          "change what the session later sees")
        inner = getattr(inner, "inner", None)
    return src, None


def _read_slice(p: "_Plan", lo: int, hi: int) -> dict:
    """Round-slice [lo, hi) on the plan's device, as ``Session`` reads it:
    views of resident data, else the source's slice moved to the device."""
    src = p.read_source
    if src.resident:
        return {k: v[:, lo:hi] for k, v in src.shards.items()}
    return {k: DS.as_tensor(v).to(p.device) for k, v in src.slice_cols(lo, hi).items()}


def _snapshot(mesh):
    stats = None if mesh is None else (mesh._seconds, mesh._bytes, mesh._calls)
    return dict(RT.LAUNCHES), dict(RT.DISPATCHES), SC.CHUNK_STEPS, stats


def _restore(snap, mesh) -> None:
    launches, dispatches, chunk_steps, stats = snap
    RT.LAUNCHES.update(launches)
    RT.DISPATCHES.update(dispatches)
    SC.CHUNK_STEPS = chunk_steps
    if stats is not None:
        mesh._seconds, mesh._bytes, mesh._calls = stats


class _Plan:
    """One audited plan: its shape math and its dry step (run once)."""

    def __init__(self, gla, source, whole, sched: np.ndarray, *, emit: str,
                 mode: str, lanes: int, confidence: float, mesh, device: torch.device):
        self.gla, self.source, self.sched = gla, source, sched
        self.emit, self.lanes, self.confidence = emit, lanes, confidence
        self.mesh, self.device = mesh, device
        self.whole = whole
        self.P, self.C, self.L = whole.P, whole.C, whole.L
        self.n = source.spec.P  # partitions this process steps
        self.R = sched.shape[1] - 1
        self.uniform = bool(np.all(sched == sched[0]))
        self.widths = sorted({int(sched[0, r + 1] - sched[0, r])
                              for r in range(self.R)}) if self.uniform else []
        self.steppable = mode == "async" and self.uniform
        self.encodings = tuple(source.encodings or ())
        # the session's own routing: the audit certifies the path it runs
        self.path = SN.session_path(gla, source.spec.columns, emit, lanes)
        self.read_source, reason = _dry_source(source)
        self.no_dry = reason if self.steppable else (
            "plan cannot step incrementally (sync mode or a non-uniform schedule)")
        self._dry = None

    def col_bytes(self, width: int, parts: Optional[int] = None) -> int:
        """Bytes of every logical column over [parts, width, L] (this
        process's partitions by default; trailing dims included)."""
        n = self.n if parts is None else parts
        total = 0
        for c in self.source.spec.columns:
            k = n * width * self.L
            for t in c.trailing:
                k *= t
            total += k * np.dtype(c.dtype).itemsize
        return total

    def init_states(self):
        batch = (self.n,) if self.path != "scan" or self.lanes == 1 else (self.n, self.lanes)
        return SC.stack_init(self.gla, batch, self.device)

    def dry(self) -> Optional[dict]:
        """The dry step's counts and trees, or None (see ``no_dry``)."""
        if self._dry is None and self.no_dry is None:
            self._dry = _dry_step(self)
        return self._dry


def _dry_step(p: _Plan) -> dict:
    """Read round-slice 0, advance a throwaway carry over it on the plan's
    path, merge the round (across the group under a mesh), and return the
    counter deltas, the bytes handed, the card's peak and the trees
    (:func:`audit_plan` puts the counters back afterwards)."""
    lo, hi = int(p.sched[0, 0]), int(p.sched[0, 1])
    dev, mesh = p.device, p.mesh
    cuda = dev.type == "cuda"
    first = p.path not in ("scan", "kernel_fused")  # delta paths start from the delta
    init = p.init_states()
    w_r = torch.ones((p.P,), dtype=torch.float32, device=dev)
    d_local = torch.full((p.P,), float(p.C * p.L), dtype=torch.float32, device=dev)
    d_total = d_local.sum()
    base = None
    if cuda:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    steps0, disp0, launch0 = SC.CHUNK_STEPS, dict(RT.DISPATCHES), dict(RT.LAUNCHES)
    calls0 = None if mesh is None else mesh.stats()["calls"]
    handed = {}

    def advance():
        cols = _read_slice(p, lo, hi)
        handed["slice"], handed["carry"] = _nbytes(cols), _nbytes(init)
        return SC.round_step(p.gla, init, cols, path=p.path, lanes=p.lanes,
                             first=first, encodings=p.encodings), ()

    if mesh is None:
        (states, views), _ = advance()
        merged, est = EN._merge_round(p.gla, views, w_r, d_local, d_total,
                                      p.confidence, True)
    else:
        (states, views), _ = SH.checked(mesh, p.P, advance)
        views, merged, est = SH.session_step_sharded(
            p.gla, views, w_r, d_local, d_total, mesh=mesh,
            confidence=p.confidence, all_alive=True)
    peak = None
    if cuda:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
    return {
        "width": hi - lo,  # the plan's, whatever the step was handed
        "chunk_steps": SC.CHUNK_STEPS - steps0,
        "dispatches": {k: n - disp0[k] for k, n in RT.DISPATCHES.items()},
        "launches": {k: n - launch0[k] for k, n in RT.LAUNCHES.items() if n > launch0[k]},
        "calls": None if mesh is None else mesh.stats()["calls"] - calls0,
        "handed_bytes": handed["slice"] + handed["carry"],
        "carry_bytes": handed["carry"],
        "peak_bytes": peak,
        "trees": {"init": init, "states": states, "views": views,
                  "merged": merged, "estimate": est},
    }


def _skip(name: str, reason: str) -> CheckResult:
    return CheckResult(name, "skip", reason)


def _merge_results(name: str, parts) -> CheckResult:
    """Combine per-program results for one check into a single verdict."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return _skip(name, "no program to audit for this plan")
    fails = [p for p in parts if p.failed]
    if fails:
        return fails[0]
    passes = [p for p in parts if p.passed]
    if passes:
        data = {}
        for p in passes:
            data.update(p.data)
        return CheckResult(name, "pass", "; ".join(p.detail for p in passes), data)
    return CheckResult(name, "skip", "; ".join(p.detail for p in parts))


def _decode_launches(p: _Plan) -> int:
    return -(-len(p.encodings) // KD.MAX_COLUMNS)


def _audit_one_chunk_pass(p: _Plan) -> CheckResult:
    name = "one_chunk_pass"
    if p.path != "scan":
        return _skip(name, "kernel plans have no chunk scan loop — dispatch "
                           "structure is certified by single_kernel_dispatch")
    if p.emit == "round_masked":
        return _skip(name, "emit='round_masked' re-scans all chunks per round — "
                           "O(R*C) by design (DESIGN.md §3)")
    if p.emit not in ("chunk", "round"):
        return _skip(name, f"emit={p.emit!r} not audited")
    parts = []
    if p.source.resident:
        parts.append(_skip(name, "the whole-scan program is not run by the audit "
                                 "(the port compiles no program to read)"))
    d = p.dry()
    if d is not None:
        parts.append(check_one_chunk_pass(d["chunk_steps"], width=d["width"],
                                          where="dry step"))
    else:
        parts.append(_skip(name, p.no_dry))
    return _merge_results(name, parts)


def _audit_slice_footprint(p: _Plan) -> CheckResult:
    d = p.dry()
    if d is None:
        return _skip("o_slice_footprint", p.no_dry)
    w = d["width"]
    return check_slice_footprint(
        d["handed_bytes"], slice_bytes=p.col_bytes(w), carry_bytes=d["carry_bytes"],
        floor_bytes=p.n * w * p.L * 4, dataset_bytes=p.col_bytes(p.C),
        peak_bytes=d["peak_bytes"], where="dry step")


def _audit_kernel_dispatch(p: _Plan) -> CheckResult:
    name = "single_kernel_dispatch"
    if p.path == "scan":
        return _skip(name, "not a kernel plan (emit != 'kernel')")
    if p.path == "kernel_fused":
        return _skip(name, "fused kernel plan — certified by fused_single_dispatch")
    d = p.dry()
    if d is None:
        return _skip(name, p.no_dry)
    kernel = "shard_chunk_partials" if p.path == "kernel_scalar" else "group_agg"
    res = check_dispatches(name, d["dispatches"],
                           expected={kernel: 1, "decode": _decode_launches(p)},
                           where=f"dry step, one launch for all {p.n} partitions")
    return CheckResult(name, res.status, res.detail, {**res.data, "launches": d["launches"]})


def _audit_fused_dispatch(p: _Plan) -> CheckResult:
    name = "fused_single_dispatch"
    if p.path != "kernel_fused":
        return _skip(name, "plan does not take the fused kernel path (no "
                           "FusedSpec, non-f32 state, or trailing-dim columns)")
    d = p.dry()
    if d is None:
        return _skip(name, p.no_dry)
    members = p.gla.members or ()
    if members:
        kind, launches = "bundle", -(-len(members) // FK.MAX_BUNDLE_MEMBERS)
    else:
        kind, launches = ("group" if p.gla.fused.group is not None else "scalar"), 1
    dec = _decode_launches(p)
    res = check_dispatches(name, d["dispatches"],
                           expected={f"fused_round_step/{kind}": launches, "decode": dec})
    pbytes = FK.probe_bytes(p.gla)
    data = {**res.data, "launches": d["launches"],
            "encoded_cols": [c for c, _ in p.encodings],
            "decode_launches": dec, "decode_in_kernel": False,
            "probe_bytes": pbytes, "probe_budget_bytes": FK.REFERENCE_PROBE_BUDGET_BYTES}
    if res.failed:
        return CheckResult(name, "fail", res.detail, data)
    probe = f", {pbytes}B of join probe tables as kernel operands" if pbytes else ""
    decode = (f"; the {len(p.encodings)} encoded column(s) decode in {dec} pf_decode "
              "launch(es) of their own ahead of it" if dec else "")
    return CheckResult(
        name, "pass",
        f"{launches} fused_round_step/{kind} launch(es) per round-slice for all "
        f"{p.n} partitions cover {len(members) or 1} member(s), predicate, "
        f"bucketing and accumulation{probe}{decode}", data)


def _audit_bytes_moved(p: _Plan) -> CheckResult:
    if not p.encodings:
        return _skip("bytes_moved", "no encoded columns — the physical stream "
                                    "already is the logical stream")
    w = max(p.widths) if p.widths else p.C

    def _bytes(like) -> int:
        return sum(int(np.prod(shape)) * np.dtype(dt).itemsize for shape, dt in like.values())

    whole = p.whole
    phys = _bytes(DS.ChunkSpec(whole.P, whole.C, whole.L,
                               p.source.physical_columns()).slice_like(w))
    logical = _bytes(whole.slice_like(w))
    ratio = phys / logical
    data = {"physical_bytes": phys, "logical_bytes": logical, "ratio": ratio,
            "encoded_cols": [c for c, _ in p.encodings]}
    if ratio <= 0.95:
        return CheckResult("bytes_moved", "pass",
                           f"encoded round-slice streams {phys}B for {logical}B of "
                           f"logical columns ({ratio:.2f}x)", data)
    return CheckResult(
        "bytes_moved", "fail",
        f"encoded round-slice streams {phys}B vs {logical}B logical ({ratio:.2f}x) "
        "— encodings are not shrinking the stream measurably (<= 0.95x required)",
        data)


def _audit_collectives(p: _Plan) -> CheckResult:
    name = "one_collective_per_round"
    if p.mesh is None:
        return _skip(name, "one process merges every partition's views on its "
                           "device — no collectives to count (pass mesh= for a "
                           "partition group)")
    if p.mesh.world <= 1:
        return _skip(name, "1-rank group — its collectives move nothing")
    d = p.dry()
    if d is None:
        return _skip(name, "plan cannot step incrementally — per-round "
                           "collective structure undefined")
    return check_collectives(d["calls"], width=d["width"], where="dry step's round")


def _audit_dtype(p: _Plan) -> CheckResult:
    d = p.dry()
    return check_dtype_discipline(
        {"init": p.init_states()} if d is None else d["trees"])


def _audit_no_recompile(p: _Plan) -> CheckResult:
    return _skip("no_recompile_across_rounds", "the port compiles no step program")


_CHECK_FNS: Dict[str, Callable[[_Plan], CheckResult]] = {
    "one_chunk_pass": _audit_one_chunk_pass,
    "o_slice_footprint": _audit_slice_footprint,
    "single_kernel_dispatch": _audit_kernel_dispatch,
    "fused_single_dispatch": _audit_fused_dispatch,
    "bytes_moved": _audit_bytes_moved,
    "one_collective_per_round": _audit_collectives,
    "dtype_discipline": _audit_dtype,
    "no_recompile_across_rounds": _audit_no_recompile,
}


def audit_plan(gla, data, *, rounds: int = 8,
               schedule: Optional[np.ndarray] = None, emit: str = "chunk",
               mode: str = "async", lanes: int = 1, snapshots: bool = True,
               confidence: float = 0.95, mesh=None, device=None,
               checks: Optional[Sequence[str]] = None,
               raise_on_failure: bool = False) -> AuditReport:
    """Certify a query plan against the invariant catalog before it runs.

    Args mirror the reference's (``repro.core.engine.run_query``'s plan);
    the plan is resolved by ``engine.normalize_plan``, as a ``Session``
    resolves it.  ``data`` is a shards dict or any source (this rank's
    block, or the whole layout, under ``mesh``, a
    ``sharded.PartitionGroup``).  ``device`` is where the dry step runs,
    "cuda" by default (the group's under a mesh).  The checks that need
    the dry step run it once (see the module docstring): one round-slice
    is read and the result thrown away; ``checks`` defaults to
    :data:`STATIC_CHECKS`.

    Returns an :class:`AuditReport`; with ``raise_on_failure`` the report
    raises :class:`AuditError` before returning.
    """
    names = tuple(checks) if checks is not None else STATIC_CHECKS
    unknown = [n for n in names if n not in _CHECK_FNS]
    if unknown:
        raise ValueError(f"unknown audit check(s) {unknown}; catalog: "
                         f"{sorted(_CHECK_FNS)}")
    if mode not in ("async", "sync"):
        raise ValueError(f"mode must be 'async' or 'sync', got {mode!r}")
    snap = _snapshot(mesh)
    try:
        report = _audit_plan(gla, data, names, rounds=rounds, schedule=schedule,
                             emit=emit, mode=mode, lanes=lanes, snapshots=snapshots,
                             confidence=confidence, mesh=mesh, device=device)
    finally:
        _restore(snap, mesh)
    if raise_on_failure:
        report.raise_for_failures()
    return report


def _audit_plan(gla, data, names, *, rounds, schedule, emit, mode, lanes, snapshots,
                confidence, mesh, device) -> AuditReport:
    if mesh is None:
        dev = resolve_device("cuda" if device is None else device)
        source, whole = DS.as_source(data), None
    else:
        dev = SH.resolve_device(mesh, device)
        source, whole = SH.rank_view(mesh, data)
    source = DS.place(source, dev)
    whole = whole or source.spec
    qspec = EN.normalize_plan(QS.QuerySpec(
        gla, rounds=rounds, schedule=schedule, emit=emit, sync=mode == "sync",
        lanes=lanes, snapshots=snapshots, confidence=confidence), whole)
    plan = _Plan(qspec.gla, source, whole, np.asarray(qspec.schedule, np.int32),
                 emit=qspec.emit, mode=mode, lanes=lanes, confidence=confidence,
                 mesh=mesh, device=dev)
    results = tuple(_CHECK_FNS[n](plan) for n in names)
    return AuditReport(
        plan={"gla": qspec.gla.name,
              "engine": "sharded" if mesh is not None else "vmapped",
              "emit": qspec.emit, "mode": mode, "path": plan.path,
              "P": plan.P, "C": plan.C, "L": plan.L, "rounds": plan.R,
              "lanes": lanes, "backend": dev.type},
        results=results)


# ---------------------------------------------------------------------------
# serving churn audit (repro_torch/service.py)
# ---------------------------------------------------------------------------

def audit_service(family, data, *, rounds: int = 4, confidence: float = 0.95,
                  mesh=None, device=None, raise_on_failure: bool = False) -> AuditReport:
    """Certify the serving layer's plan discipline under churn.

    Drives a throwaway :class:`repro_torch.service.SharedScan` through the
    reference's membership workload — staggered attaches forcing at least
    one slot-capacity doubling, every group bank of the family, and a
    detach-then-reattach slot reuse — and holds the step plans it built
    (``service.serve_step_cache_sizes``) to the scan's budget: one per
    (bank, capacity) actually stepped.  A plan built per arrival blows the
    budget at once: the workload makes 3 + #groups + 2 membership changes
    against a budget of ~2 + #groups.  The scan's steps run on ``device``
    ("cuda" by default); the launch and dispatch counts are put back as
    they were.
    """
    from repro_torch import service as SV
    from repro_torch.gla import SlotQuery

    def q(i: int) -> SlotQuery:
        return SlotQuery(family.expr_names[i % len(family.expr_names)])

    snap = _snapshot(mesh)
    scan = None
    try:
        scan = SV.SharedScan(family, data, rounds=rounds, confidence=confidence,
                             mesh=mesh, device=device)
        plan = {"gla": f"slot-family[{'+'.join(family.expr_names)}]",
                "engine": "sharded" if mesh is not None else "vmapped",
                "emit": "serve", "mode": "async", "P": scan.P, "C": scan.C,
                "rounds": scan.rounds, "backend": scan.device.type}
        before = SV.serve_step_cache_sizes()
        recs = [scan.attach(q(0))]
        scan.step()                               # scalar K=1
        recs += [scan.attach(q(1)), scan.attach(q(2))]
        scan.step()                               # forces K=1 -> 2 -> 4
        scan.detach(recs.pop())
        reused = scan.attach(q(1))                # slot reuse: same capacity
        scan.step()
        for g in family.groups:                   # one slot per group bank
            recs.append(scan.attach(SlotQuery(family.expr_names[0], group=g)))
        scan.step()
        arrivals = 3 + len(family.groups) + 1     # membership changes made
        delta = SV.serve_step_cache_sizes() - before
        budget = scan.compile_budget()
        doublings = max(b.doublings for b in scan.banks.values())
        data_out = {"cache_miss_delta": delta, "budget": budget,
                    "arrivals": arrivals, "doublings": doublings,
                    "banks": sorted(scan.banks), "reused_slot": reused.slot,
                    "stepped_capacities": {n: sorted(b.stepped_ks)
                                           for n, b in scan.banks.items()}}
    finally:
        if scan is not None:
            scan.close()
        _restore(snap, mesh)
    name = "bounded_compiles_under_churn"
    if doublings < 1:
        result = CheckResult(name, "fail",
                             "churn workload never doubled a bank's capacity — the "
                             "check is not exercising growth", data_out)
    elif delta <= budget:
        result = CheckResult(
            name, "pass",
            f"{arrivals} membership changes ({doublings} doubling(s), "
            f"{len(scan.banks)} bank(s)) built {delta} step plan(s) "
            f"(budget {budget})", data_out)
    else:
        result = CheckResult(
            name, "fail",
            f"{arrivals} membership changes built {delta} step plans, budget "
            f"{budget} — the scan builds a plan per arrival, not per capacity",
            data_out)
    report = AuditReport(plan=plan, results=(result,))
    if raise_on_failure:
        report.raise_for_failures()
    return report


# ---------------------------------------------------------------------------
# CLI: the audit smoke (python -m repro_torch.audit)
# ---------------------------------------------------------------------------

def _smoke_data(rows: int, parts: int, chunk: int, rounds: int, device="cuda") -> dict:
    """The reference's smoke layout from the port's own generator:
    lineitem with the orders key, randomized and packed into ``parts``
    partitions with at least 2 chunks a round-slice (and chunks a round
    other than ``rounds``)."""
    from repro_torch import randomize
    from repro_torch.data import tpch

    dev = resolve_device(device)
    cols = tpch.generate_lineitem(rows, seed=7, device=dev)
    cols["orderkey"] = tpch.generate_orders_fk(rows, seed=7, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    shards = randomize.randomize_global(cols, gen, parts)
    n_chunks = -(-rows // parts // chunk)
    min_chunks = max(-(-n_chunks // rounds), 2) * rounds
    if min_chunks // rounds == rounds:
        min_chunks += rounds
    return randomize.pack_partitions(shards, chunk_len=chunk, min_chunks=min_chunks)


def _smoke_plans(rows: int, device="cuda"):
    """(name, GLA, emit) of the reference's four smoke plans: Q6 on the
    chunk scan, Q1 (K1 group), the [Q1, Q6] bundle (K1 bundle) and a Q3
    join whose probe tables ride K1."""
    from repro_torch import gla
    from repro_torch.data import tpch

    dev = resolve_device(device)
    d = float(rows)
    q6 = gla.make_sum_gla(tpch.q6_func, tpch.q6_cond(tpch.Q6_LOW_WINDOW), d_total=d)
    q1 = gla.make_groupby_gla(tpch.q1_func, tpch.q1_cond, tpch.q1_group_small,
                              num_groups=4, d_total=d, num_aggs=4)
    bundle = gla.GLABundle([q1, q6])
    segment, valid = tpch.orders_table(max(1, rows // 4), seed=14, device=dev)
    q3 = gla.make_join_groupby_gla(tpch.q6_func, tpch.q1_cond, tpch.orderkey,
                                   segment, valid, num_groups=tpch.NUM_SEGMENTS,
                                   d_total=d, device=dev)
    return [("q6", q6, "chunk"), ("q1", q1, "kernel"),
            ("bundle", bundle, "kernel"), ("q3-join", q3, "kernel")]


def smoke_family():
    """The reference CLI's slot family: Q6 and quantity over shipdate and
    discount ranges, grouped by returnflag/linestatus."""
    from repro_torch.data import tpch
    from repro_torch.gla import SlotFamily

    return SlotFamily(exprs={"q6": tpch.q6_func, "qty": lambda c: c["quantity"]},
                      pred_cols=("shipdate", "discount"),
                      groups={"rfls": (tpch.q1_group_small, 4)})


def smoke_encodings(np_shards: dict) -> dict:
    """The reference CLI's encodings of the smoke data."""
    from repro_torch.data import encodings as ENC

    return {"discount": ENC.dict_encoding_for(np_shards["discount"]),
            "shipdate": ENC.BitPackedEncoding(bits=16),
            "rfls": ENC.BitPackedEncoding(bits=2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Certify the q6/q1/bundle/q3-join smoke plans, the encoded "
                    "bundle and the serving churn against the full invariant "
                    "catalog (the audit smoke).")
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help='where the dry steps run ("cuda" by default; "cpu" '
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    failed = False
    print("# one process: a partition group's plans audit on its ranks "
          "(audit_plan(..., mesh=) on each)")
    shards = _smoke_data(args.rows, 4, 128, args.rounds, device=dev)
    plans = _smoke_plans(args.rows, device=dev)
    reports = [audit_plan(q, shards, rounds=args.rounds, emit=emit, device=dev,
                          checks=ALL_CHECKS) for _, q, emit in plans]
    # the encoded source: the decode's own launch beside one K1 launch, and
    # the physical stream shrinking
    np_shards = {k: v.cpu().numpy() for k, v in shards.items()}
    esrc = DS.EncodedSource.from_shards(np_shards, smoke_encodings(np_shards))
    bundle = dict((n, g) for n, g, _ in plans)["bundle"]
    reports.append(audit_plan(bundle, esrc, rounds=args.rounds, emit="kernel",
                              device=dev, checks=ALL_CHECKS))
    reports.append(audit_service(smoke_family(), shards, rounds=args.rounds, device=dev))
    for report in reports:
        print(report.summary())
        failed |= not report.ok
    print("audit-smoke:", "FAIL" if failed else "OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
