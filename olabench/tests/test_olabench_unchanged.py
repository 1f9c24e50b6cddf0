"""The cells read what they read before the harness took tables, query kinds
and drivers from files of their own: at the tiny size and a fixed seed, the
table's fingerprint, the drawn queries, the numbers compared and the bytes
a pass needs are the ones recorded from the harness before that change.

The analysts' loop is timed by the host, so which slots it samples is not
fixed; its numbers here are the control's on a fixed set of slots (the
first three queries of each stream, over the first one to four rounds)."""
import hashlib
import itertools

import numpy as np
import pytest

from olabench import data, passes, queries as Q, roofline, run, service_loop
from olabench.tests.tiny import CPU, SEED, base_cell, tiny_cell

FINGERPRINT = {"shipdate": 5140097, "discount": 3817355523896, "quantity": 4507941470208,
               "extendedprice": 4866225776282, "tax": 3728443660710, "rfls": 7016,
               "suppkey": 2039979}
REPORT_CHECKS = {"final_gap": 1.0163376250920355e-07, "estimate_gap": 1.1061026743423774e-07,
                 "bound_gap": 4.006125492553359e-07, "count_gap": 0.0}
REPORT_CONTROL = {"final_gap": 0.008386769597148878, "estimate_gap": 0.008386769597148878,
                  "bound_gap": 0.0200056488254518, "count_gap": 0.0}
BEFORE = {
    "sf10-report": {
        "queries": "bfdd8a3c7af3890314007fce26c55420fa2d05075d7e5964f77d6eb808802fdb",
        "pass_bytes": 2219842560, "checks": REPORT_CHECKS, "control": REPORT_CONTROL},
    "sf100-report": {
        "queries": "86ac1320a044732dad09f90a288339556a4e78ed775cca4c3dd947f7c60c294f",
        "pass_bytes": 22273252800, "checks": REPORT_CHECKS, "control": REPORT_CONTROL},
    "sf10-analyst": {
        "queries": "5424096fd61976904442c3892ab7d7f6938d4f0f85f2982e810ad6790629a0dd",
        "pass_bytes": 2219842560,
        "control": {"estimate_gap": 0.006233231008192336, "bound_gap": 0.014863363070019195,
                    "scanned_gap": 0.0}},
}


def _digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()


def _sizes(cell):
    a = cell.config["assumed"]
    return int(cell.config["rows"]), int(a["partitions"]), int(a["rounds"])


@pytest.mark.parametrize("w", sorted(BEFORE))
def test_the_tables_fingerprint_is_unchanged(w):
    assert run.load_table(tiny_cell(w).config, SEED, CPU)[1] == FINGERPRINT


@pytest.mark.parametrize("w", sorted(BEFORE))
def test_the_drawn_queries_and_needed_bytes_are_unchanged(w):
    real = base_cell(w)
    rows, P, R = _sizes(real)
    if real.traffic["kind"] == "passes":
        d = passes.Driver(real, SEED, CPU, None)
        bundles = [d.draw() for _ in range(6)]
        first = bundles[0]
    else:
        d = service_loop.Driver(real, SEED, CPU, None)
        bundles = [list(itertools.islice(d.stream_queries(s), 9)) for s in range(d.streams)]
        first = [Q.draw(np.random.default_rng(0), k, real.config)
                 for k in real.traffic["queries"]]
    assert _digest(bundles) == BEFORE[w]["queries"]
    assert roofline.pass_bytes(first, rows, P, R) == BEFORE[w]["pass_bytes"]
    assert roofline.pass_bytes(first, rows, P, R, {}) == BEFORE[w]["pass_bytes"]


@pytest.mark.parametrize("w", ["sf10-report", "sf100-report"])
def test_a_passes_cells_checks_are_unchanged(w):
    """One timed pass (a window of 0 s), checked as a run checks it."""
    out = run.run_cell(tiny_cell(w), SEED, 0.0, False, CPU, control=True)
    assert out["correct"] is True
    assert {k: c["value"] for k, c in out["checks"].items()} == BEFORE[w]["checks"]
    assert out["control"] == BEFORE[w]["control"]


def test_the_analyst_cells_control_is_unchanged():
    c = tiny_cell("sf10-analyst")
    t, a = c.config, c.config["assumed"]
    rows, P, R = _sizes(c)
    d = service_loop.Driver(c, SEED, CPU, None)
    cols = data.check_columns(t, SEED, CPU)
    lay = data.Layout(rows, SEED, P, int(a["chunk_len"]), R, CPU)
    picks = []
    for s in range(d.streams):
        for q in itertools.islice(d.stream_queries(s), 3):
            for sq in Q.slot_queries(q):
                n = 1 + len(picks) % R
                picks.append(service_loop.Record(sq, 0.0, 0.0, None, tuple(
                    (r * lay.W, (r + 1) * lay.W) for r in range(n))))
    assert len(picks) == 18
    ans = service_loop.reference_answers(picks, cols, lay)
    ctl = service_loop.reference_answers(picks, cols, lay, "bfloat16")
    conf = float(a["confidence"])
    got = service_loop.compare(service_loop.as_outputs(ctl, rows, conf), ans, rows, conf)
    assert got == BEFORE["sf10-analyst"]["control"]
