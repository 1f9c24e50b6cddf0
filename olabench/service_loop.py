"""Traffic of kind ``service``: analysts on one shared scan.

The stream structure of TPC-H 3.0.1's throughput test (§5.3.4), restricted
to the mix's queries: ``streams`` (by the configuration's scale factor: the
spec's least stream count at it) analysts each run the mix's queries in an
order of their own, drawn from the seed, again and again with fresh
substitution parameters and no think time: a closed loop on one
``service.OLAService``.  A query is answered once every slot that answers
it (one a sum: Q1's four sums are four slots) is certified at the
configuration's ``certify_eps`` (``rel_width``) or finished by a full pass.
Each stream draws from a generator of its own, so a seed gives the same
queries whatever the timing.  The first ``warmup_cycles`` of every stream
are set-up: the banks grow to the sizes the loop keeps them at.
"""
from __future__ import annotations

import asyncio
import time
from typing import List, NamedTuple

import numpy as np
import torch

from olabench import data, queries as Q, reference as REF, roofline


class Record(NamedTuple):
    """One slot: a query with one sum."""

    query: Q.Query
    t_submit: float
    t_done: float
    outcome: object  # service.QueryOutcome, or the exception it failed with
    witnessed: tuple  # the chunk ranges the program reports it aggregated


class Ask(NamedTuple):
    """One analyst's query: the slots that answer it."""

    query: Q.Query
    t_submit: float
    t_done: float
    slots: tuple  # Records

    @property
    def failed(self) -> bool:
        return any(isinstance(r.outcome, BaseException) for r in self.slots)


def stream_count(traffic: dict, config: dict) -> int:
    return int(traffic["streams"][str(int(config["scale_factor"]))])


class Driver:
    def __init__(self, cell, seed: int, device, shards, dims=None):
        self.cfg, self.mix = cell.config, cell.traffic
        # ``dims`` goes unused: the slot family (``Q.port_family``) probes no dimension table
        self.device, self.shards = device, shards
        self.seed = int(seed)
        self.rows = int(self.cfg["rows"])
        self.suppliers = int(self.cfg["suppliers"])
        a = self.cfg["assumed"]
        self.rounds, self.P = int(a["rounds"]), int(a["partitions"])
        self.confidence, self.eps = float(a["confidence"]), float(a["certify_eps"])
        self.streams = stream_count(self.mix, self.cfg)
        self.asks: List[Ask] = []

    def stream_queries(self, s: int):
        """Stream ``s``'s queries, in its order, without end."""
        rng = np.random.default_rng([self.seed, 1, s])
        order = [str(k) for k in rng.permutation(self.mix["queries"])]
        while True:
            for kind in order:
                yield Q.draw(rng, kind, self.cfg)

    def run(self, seconds: float, tracer=None) -> dict:
        return asyncio.run(self._run(seconds, tracer))

    async def _run(self, seconds: float, tracer) -> dict:
        import repro_torch as T

        svc = T.OLAService(Q.port_family(self.suppliers), rounds=self.rounds,
                           confidence=self.confidence, device=self.device)
        flags = {"stop": False}
        warm = asyncio.Event()
        n_warm = int(self.mix["warmup_cycles"]) * len(self.mix["queries"]) * self.streams

        async def answer(sq):
            spec = T.QuerySpec(Q.port_slot(sq), stop=T.rel_width(self.eps),
                               rounds=self.rounds, confidence=self.confidence)
            t_sub = time.perf_counter()
            h = await svc.submit(spec, self.shards)
            try:
                out = await h.result()
            except Exception as err:  # a failed query counts as failed, not lost
                out = err
            rec = getattr(h, "_record", None)
            return Record(sq, t_sub, time.perf_counter(), out,
                          tuple(getattr(rec, "witnessed", ())))

        async def stream(s):
            queries = self.stream_queries(s)
            while not flags["stop"]:
                q = next(queries)
                t_sub = time.perf_counter()
                slots = await asyncio.gather(*(answer(sq) for sq in Q.slot_queries(q)))
                self.asks.append(Ask(q, t_sub, max(r.t_done for r in slots), tuple(slots)))
                if len(self.asks) >= n_warm:
                    warm.set()

        async with svc:
            tasks = [asyncio.create_task(stream(s)) for s in range(self.streams)]
            await warm.wait()
            scan = svc.scan_for(self.shards)
            t0, s0 = time.perf_counter(), scan.steps_done
            seen = {"banks_at_start": {n: b.K for n, b in scan.banks.items()}}
            traced, ticks = {}, []

            async def tick():  # steps done each second of the window
                while not flags["stop"]:
                    ticks.append(scan.steps_done)
                    await asyncio.sleep(1.0)
            ticker = asyncio.create_task(tick())
            if tracer is not None:  # profile the middle 40% of the window
                await asyncio.sleep(0.3 * seconds)
                traced.update(t_a=time.perf_counter(), a=scan.steps_done)
                tracer.start()
                traced["s0"] = scan.steps_done
                await asyncio.sleep(0.4 * seconds)
                traced["s1"] = scan.steps_done
                tracer.stop()
                traced.update(t_b=time.perf_counter(), b=scan.steps_done)
                await asyncio.sleep(max(0.0, t0 + seconds - time.perf_counter()))
            else:
                await asyncio.sleep(seconds)
            flags["stop"] = True
            t1, s1 = time.perf_counter(), scan.steps_done
            seen["banks_at_end"] = {n: b.K for n, b in scan.banks.items()}
            await ticker
            seen["steps_a_second"] = [b - a for a, b in zip(ticks, ticks[1:])]
            await asyncio.gather(*tasks)
            steps_total = scan.steps_done
        return self._result(t0, t1, s0, s1, steps_total, traced, seen)

    def _result(self, t0, t1, s0, s1, steps_total, traced, seen) -> dict:
        steps = s1 - s0
        window_s = t1 - t0
        sub_in = [k for k in self.asks if t0 <= k.t_submit < t1]
        done_in = [k for k in self.asks if t0 <= k.t_done <= t1 and not k.failed]
        failed = sum(k.failed for k in sub_in)
        lat = [k.t_done - k.t_submit for k in sub_in if not k.failed]
        p95 = float(np.percentile(lat, 95)) * 1e3 if lat else None
        certified = [k for k in sub_in if not k.failed
                     and all(r.outcome.converged for r in k.slots)]
        ok = [r for k in self.asks for r in k.slots if not isinstance(r.outcome, BaseException)]
        witnessed = sum(r.outcome.rounds_witnessed for r in ok)
        slice_rows = self.rows / self.rounds
        kinds = [Q.draw(np.random.default_rng(0), k, self.cfg) for k in self.mix["queries"]]
        step_bytes = roofline.row_bytes(kinds) * slice_rows
        state_per_step = sum(2 * roofline.state_bytes(r.query, self.P) * r.outcome.rounds_witnessed
                             for r in ok) / max(steps_total, 1)
        ctx = {"kind": "service", "window_s": window_s, "steps": steps, "streams": self.streams,
               "slots_per_step": witnessed / max(steps_total, 1),
               "latency_p95_ms": p95, "latency_samples": len(lat),
               "rounds_to_eps_mean": (float(np.mean([max(r.outcome.rounds_witnessed for r in k.slots)
                                                     for k in certified]))
                                      if certified else None), **seen}
        if traced:  # host times outside the profiled stretch, start and stop included
            untraced_s = (traced["t_a"] - t0) + (t1 - traced["t_b"])
            untraced_steps = (traced["a"] - s0) + (s1 - traced["b"])
            if untraced_steps > 0:
                ctx["step_ms"] = untraced_s / untraced_steps * 1e3
            ts = traced["s1"] - traced["s0"]
            ctx.update(traced_steps=ts, traced_needed_bytes=ts * (step_bytes + state_per_step))
            lat_out = [k.t_done - k.t_submit for k in sub_in if not k.failed
                       and (k.t_done < traced["t_a"] or k.t_submit > traced["t_b"])]
            ctx["latency_p95_ms_untraced"] = (float(np.percentile(lat_out, 95)) * 1e3
                                              if lat_out else None)
        else:
            ctx["step_ms"] = window_s / max(steps, 1) * 1e3
        e2e = {"certified_qps": len(done_in) / window_s}
        if p95 is not None:
            e2e["time_to_eps_p95_ms"] = p95
        return {"ctx": ctx, "e2e": e2e, "attempted": len(sub_in), "failed": failed,
                "t_start": t0}

    # -- the check -------------------------------------------------------------

    def sample(self, seed: int, n: int, t0: float) -> list:
        """The slots the reference checks: of those submitted in the window
        and answered, the one that witnessed the most rounds and ``n - 1``
        more drawn from the seed."""
        pool = [r for k in self.asks for r in k.slots
                if r.t_submit >= t0 and not isinstance(r.outcome, BaseException)]
        if not pool:
            return []
        longest = max(range(len(pool)), key=lambda i: pool[i].outcome.rounds_witnessed)
        rest = [i for i in range(len(pool)) if i != longest]
        rng = np.random.default_rng([int(seed), 2])
        pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False).tolist()
        return [pool[longest]] + [pool[rest[i]] for i in pick]

    def subjects(self, picks: List[Record]) -> List[Record]:
        return picks

    def outputs(self, picks: List[Record]) -> list:
        """The picked queries' answers: estimate and bounds, rows scanned,
        rounds witnessed."""
        out = []
        for r in picks:
            e = r.outcome.estimate
            out.append({"estimate": torch.as_tensor(e.estimate), "lower": torch.as_tensor(e.lower),
                        "upper": torch.as_tensor(e.upper), "scanned": float(r.outcome.scanned),
                        "rounds": int(r.outcome.rounds_witnessed)})
        return out

    def release(self) -> None:
        self.shards = None  # the outcomes' estimates are on the CPU already


def reference_answers(picks: List[Record], cols, layout: data.Layout,
                      precision: str = "float64", dims=None) -> list:
    """The reference's (or the control's) sums over each picked query's
    witnessed rounds, the rounds taken from the chunk ranges the program
    reports (a ValueError when one is no round of the layout)."""
    dev = layout.device
    rounds = [[layout.round_of(lo, hi) for lo, hi in r.witnessed] for r in picks]
    acc = [REF.zero(r.query, dev) for r in picks]
    need = sorted({x for rs in rounds for x in rs})
    for rr, rc in data.gather_rounds(cols, layout, need):
        for i, r in enumerate(picks):
            if rr in rounds[i]:  # a slot witnesses a round once at most
                acc[i] = acc[i] + REF.sums(rc, r.query, precision, dims)
    return [(s, len(rs)) for s, rs in zip(acc, rounds)]


def as_outputs(answers, rows: int, confidence: float) -> list:
    out = []
    for s, n in answers:
        e = REF.estimate(s, rows, confidence)
        out.append({"estimate": e.estimate, "lower": e.lower, "upper": e.upper,
                    "scanned": float(s.scanned), "rounds": n})
    return out


def compare(outs, answers, rows: int, confidence: float) -> dict:
    """``estimate_gap`` and ``bound_gap`` of each picked query's last
    estimate, and ``scanned_gap``: rows scanned and rounds witnessed against
    the reference's count of the rows of the rounds reported (exact)."""
    from olabench.passes import bound_gap

    worst = dict.fromkeys(("estimate_gap", "bound_gap", "scanned_gap"), 0.0)
    for o, (s, n) in zip(outs, answers):
        ref = REF.estimate(s, rows, confidence)
        shape = s.sum.shape
        worst["estimate_gap"] = max(worst["estimate_gap"],
                                    REF.gap(o["estimate"].reshape(shape), ref.estimate))
        for p_b, r_b in ((o["lower"], ref.lower), (o["upper"], ref.upper)):
            worst["bound_gap"] = max(worst["bound_gap"],
                                     bound_gap(p_b.reshape(shape), r_b, ref.estimate.abs()))
        worst["scanned_gap"] = max(worst["scanned_gap"], abs(o["scanned"] - s.scanned),
                                   abs(o["rounds"] - n))
    return worst
