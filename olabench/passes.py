"""Traffic of kind ``passes``: a closed loop of exact shared passes.

``callers`` callers (one in the ``report`` mix) each ask, with no think
time, for one exact pass of a bundle of queries through
``engine.run_queries(..., emit="kernel")``: the bundle's members are drawn
from the mix's ``bundle`` entries with fresh substitution parameters a
pass, every round's estimates are kept, and the pass is done when its
results are on the device and the device has finished.  Only one caller
is supported: a pass keeps the card to itself.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from olabench import data, queries as Q, reference as REF, roofline


EARLY = 20  # the checked passes are drawn among the window's first EARLY


class Driver:
    def __init__(self, cell, seed: int, device, shards, dims=None):
        if cell.traffic.get("callers", 1) != 1:
            raise ValueError("the passes driver runs one caller")
        self.cfg, self.mix = cell.config, cell.traffic
        self.device, self.shards = device, shards
        self.dims = {} if dims is None else dims
        self.rng = np.random.default_rng([int(seed), 1])
        self.rows = int(self.cfg["rows"])
        self.rounds = int(self.cfg["assumed"]["rounds"])
        self.P = int(self.cfg["assumed"]["partitions"])
        # the passes the reference checks: n - 1 drawn from the seed among the
        # window's first EARLY, and the last; only those keep their results,
        # so the device holds no more than the program needs
        n = int(self.mix["check_samples"])
        self.keep = set(np.random.default_rng([int(seed), 2]).choice(
            EARLY, size=n - 1, replace=False).tolist())
        self.done: Dict[int, tuple] = {}  # pass index -> (queries, results)

    def draw(self):
        return [Q.draw(self.rng, m["query"], self.cfg) for m in self.mix["bundle"]]

    def one_pass(self, qs):
        import repro_torch as T

        glas = [Q.kind(q.kind).port_gla(q, float(self.rows), self.dims) for q in qs]
        spec = T.QuerySpec(glas, rounds=self.rounds, emit="kernel",
                           confidence=float(self.cfg["assumed"]["confidence"]))
        res = T.run_queries(spec, self.shards, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return res

    def run(self, seconds: float, tracer=None) -> dict:
        """Set-up's warm passes, then passes back to back until ``seconds``
        have gone by; with ``tracer``, the passes from the first that starts
        after 30% of the window until 40% of it has been profiled."""
        from repro_torch.kernels import _runtime as RT

        for _ in range(int(self.mix["warmup_passes"])):
            self.one_pass(self.draw())
        t0 = time.perf_counter()
        passes = traced = 0
        times = []
        launches = None
        while True:
            if tracer is not None and tracer.t0 is None and time.perf_counter() - t0 >= 0.3 * seconds:
                tracer.start()
                launches = sum(RT.DISPATCHES.values())
            tracing = tracer is not None and tracer.t0 is not None and tracer.t1 is None
            qs = self.draw()
            t = time.perf_counter()
            self.done[passes] = (qs, self.one_pass(qs))
            if passes - 1 not in self.keep:  # the previous pass was not the last
                self.done.pop(passes - 1, None)
            passes += 1
            if tracing:
                traced += 1
                if time.perf_counter() - tracer.t0 >= 0.4 * seconds:
                    tracer.stop()
                    launches = sum(RT.DISPATCHES.values()) - launches
            times.append(time.perf_counter() - t)
            if time.perf_counter() - t0 >= seconds and (tracer is None or tracer.t0 is not None):
                break  # a traced run profiles one pass at least, however long a pass takes
        if tracer is not None and tracer.t0 is not None and tracer.t1 is None:
            tracer.stop()  # the window closed inside the profiled stretch
            launches = sum(RT.DISPATCHES.values()) - launches
        window_s = time.perf_counter() - t0
        per_pass = roofline.pass_bytes(self.done[passes - 1][0], self.rows, self.P, self.rounds,
                                       self.dims)
        ctx = {"kind": "passes", "window_s": window_s, "passes": passes,
               "rows": self.rows, "rounds": self.rounds,
               "needed_bytes": per_pass * passes}
        ctx["pass_ms_quartiles"] = [float(x) * 1e3 for x in np.percentile(times, [25, 50, 75])]
        if traced:
            ctx.update(traced_passes=traced, traced_rounds=traced * self.rounds,
                       traced_needed_bytes=per_pass * traced, traced_launches=launches)
        e2e = {"rows_per_s": passes * self.rows / window_s}
        return {"ctx": ctx, "e2e": e2e, "attempted": passes, "failed": 0, "t_start": t0}

    # -- the check -------------------------------------------------------------

    def sample(self, seed: int, n: int, t0: float) -> list:
        """The passes the reference checks: those kept (drawn from the seed
        at the start, and the last one)."""
        return sorted(self.done)

    def subjects(self, picks) -> list:
        """What the reference answers: the picked passes' queries."""
        return [self.done[i][0] for i in picks]

    def outputs(self, picks) -> list:
        """The picked passes' outputs on the CPU: a member each, its final,
        its estimates and bounds a round, and its scanned and matched a round."""
        out = []
        for i in picks:
            members = []
            for r in self.done[i][1]:
                e, s = r.estimates, r.snapshots
                members.append({k: v.detach().cpu() for k, v in (
                    ("final", r.final), ("estimate", e.estimate), ("lower", e.lower),
                    ("upper", e.upper), ("scanned", s.scanned), ("matched", s.matched))})
            out.append(members)
        return out

    def release(self) -> None:
        self.done.clear()
        self.shards = self.dims = None


def reference_answers(picks, cols, layout: data.Layout, precision: str = "float64",
                      dims=None) -> list:
    """The reference's (or, in "bfloat16", the control's) answers to the
    picked passes' queries over ``cols`` and the dimension tables ``dims``:
    a pass each, a member each, a round each, the cumulative
    :class:`reference.Sums` over rounds 0..r."""
    dev = layout.device
    acc = [[REF.zero(q, dev) for q in qs] for qs in picks]
    out = [[[] for _ in qs] for qs in picks]
    for _, rc in data.gather_rounds(cols, layout, range(layout.R)):
        for i, qs in enumerate(picks):
            for j, q in enumerate(qs):
                acc[i][j] = acc[i][j] + REF.sums(rc, q, precision, dims)
                out[i][j].append(acc[i][j])
    return out


def as_outputs(answers, rows: int, confidence: float) -> list:
    """Answers in the form :meth:`Driver.outputs` gives the program's: the
    control, put in the program's place."""
    out = []
    for pas in answers:
        members = []
        for per in pas:
            ests = [REF.estimate(s, rows, confidence) for s in per]
            members.append({
                "final": per[-1].sum,
                "estimate": torch.stack([e.estimate for e in ests]),
                "lower": torch.stack([e.lower for e in ests]),
                "upper": torch.stack([e.upper for e in ests]),
                "scanned": torch.tensor([float(s.scanned) for s in per]),
                "matched": torch.stack([s.matched for s in per])})
        out.append(members)
    return out


def compare(outputs, answers, rows: int, confidence: float) -> dict:
    """The widest gap of each compared number over the picked passes:
    ``final_gap`` (each member's exact answer), ``estimate_gap`` and
    ``bound_gap`` (every round's estimate and bounds) and ``count_gap``
    (every round's scanned and matched)."""
    worst = dict.fromkeys(("final_gap", "estimate_gap", "bound_gap", "count_gap"), 0.0)
    for members, pas in zip(outputs, answers):
        for m, per in zip(members, pas):
            for r, s in enumerate(per):
                ref = REF.estimate(s, rows, confidence)
                shape = s.sum.shape
                worst["estimate_gap"] = max(worst["estimate_gap"],
                                            REF.gap(m["estimate"][r].reshape(shape), ref.estimate))
                for p_b, r_b in ((m["lower"][r], ref.lower), (m["upper"][r], ref.upper)):
                    worst["bound_gap"] = max(worst["bound_gap"], bound_gap(
                        p_b.reshape(shape), r_b, ref.estimate.abs()))
                worst["count_gap"] = max(
                    worst["count_gap"],
                    REF.gap(m["matched"][r].reshape(s.matched.shape), s.matched),
                    REF.gap(m["scanned"][r].reshape(1),
                            torch.tensor([float(s.scanned)], dtype=torch.float64)))
            worst["final_gap"] = max(worst["final_gap"],
                                     REF.gap(m["final"].reshape(per[-1].sum.shape), per[-1].sum))
    return worst


def bound_gap(port, ref, scale) -> float:
    """A bound's gap in the estimate's units: against the larger of the
    cell's |estimate| and the answer's median one.  An infinite bound
    (fewer than two rows) must be infinite on both sides."""
    p = torch.as_tensor(port).to(device=ref.device, dtype=torch.float64)
    inf = torch.isinf(ref)
    if bool((torch.isinf(p) != inf).any()) or bool(torch.isnan(p).any()):
        return float("inf")
    diff = torch.where(inf, torch.zeros_like(ref), (p - ref).abs())
    den = torch.clamp(scale, min=float(scale.flatten().median()))
    return float(torch.where(diff == 0, torch.zeros_like(diff), diff / den).max())
