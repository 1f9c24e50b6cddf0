"""The readers of the port's own spans and counters (``olabench/spans.py``
and the five ``metrics/*.report.py`` files that use it) against a
synthetic ``repro_torch.obs`` store: the right value a pass or a
round-slice, and None where the run holds nothing for them."""
import sys

import pytest

from olabench import bench
from olabench.tests import tiny  # noqa: F401 — puts src/ on the path

from repro_torch import obs

MS, US = 1e6, 1e3


def _store(passes=3):
    def sp(count, total, self_):
        return {"count": count, "total_ns": total, "self_ns": self_}

    return {
        "spans": {
            "pfola.pass": sp(passes, 900 * MS, 1.5 * MS),
            "pfola.session.init": sp(passes, 0.9 * MS, 0.9 * MS),
            "pfola.scan": sp(passes, 30 * MS, 3 * MS),
            "pfola.round": sp(16 * passes, 24 * MS, 4.8 * MS),
            "pfola.project": sp(48 * passes, 12 * MS, 12 * MS),
            "pfola.kernel": sp(16 * passes, 3.2 * MS, 3.2 * MS),
            "pfola.merge": sp(passes, 860 * MS, 6 * MS),
            "pfola.estimate": sp(passes, 5 * MS, 1.2 * MS),
            "pfola.sync.weights": sp(passes, 840 * MS, 840 * MS),
            "pfola.sync.d_copy": sp(3 * passes, 2.1 * MS, 2.1 * MS),
            "pfola.sync.zq": sp(3 * passes, 1.5 * MS, 1.5 * MS),
            "pfola.serve.step": sp(2, 5 * MS, 5 * MS),  # not a pass's
        },
        "counters": {"pfola.sync": 7 * passes},
        "counters_by_span": {"pfola.sync": {"pfola.sync.weights": passes,
                                            "pfola.sync.d_copy": 3 * passes,
                                            "pfola.sync.zq": 3 * passes}},
        "records": 0, "dropped": 0,
    }


def _ctx(passes=3, rounds=16, kind="passes"):
    return {"kind": kind, "traced_passes": passes, "traced_rounds": passes * rounds}


WANT = {  # what _store(3) gives over _ctx(3): its totals over 3 passes, 48 round-slices
    "entry_host_ms": (1.5 + 0.9) / 3,
    "wrapper_host_us": (4.8 + 12 + 3.2) * MS / US / 48,
    "merge_host_ms": (3 + 6 + 1.2) / 3,
    "sync_wait_ms": (840 + 2.1 + 1.5) / 3,
    "host_syncs": 7.0,
}


@pytest.mark.parametrize("suffix", [".report", ".report_host"])
@pytest.mark.parametrize("quantity", sorted(WANT))
def test_each_reader_reads_its_spans(quantity, suffix, monkeypatch):
    monkeypatch.setattr(obs, "summary", lambda: _store(3))
    got = bench.metric_reader(quantity + suffix)(_ctx(3))
    assert isinstance(got, float) and got == pytest.approx(WANT[quantity], rel=1e-12)


@pytest.mark.parametrize("quantity", sorted(WANT))
@pytest.mark.parametrize("case", ["no-traced-passes", "service-run", "pass-count-mismatch",
                                  "nothing-recorded", "no-recorder"])
def test_each_reader_is_none_where_the_run_holds_nothing(quantity, case, monkeypatch):
    ctx, store = _ctx(3), _store(3)
    if case == "no-traced-passes":
        ctx = {"kind": "passes"}
    elif case == "service-run":
        ctx = _ctx(3, kind="service")
    elif case == "pass-count-mismatch":
        store = _store(4)
    elif case == "nothing-recorded":
        store = {"spans": {}, "counters": {}, "counters_by_span": {}, "records": 0,
                 "dropped": 0}
    else:  # a checkout whose port predates the recorder
        monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
        monkeypatch.delattr(sys.modules["repro_torch"], "obs")
    monkeypatch.setattr(obs, "summary", lambda: store)
    assert bench.metric_reader(quantity + ".report")(ctx) is None
