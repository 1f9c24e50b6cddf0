"""The comparison that decides ``correct``, shown to fail.

At a size a CPU test holds: the control (the reference in the program's
place, computed in bfloat16) reads above a limit of each cell kind, and a
run with the timed path broken underneath reads ``correct`` false, once
for each fault a cell can have on one card: a step that returns its state
unchanged; half of the batch left out and the rest scaled up to stand for
it; an answer altered where it is produced.  (The cells run on one card,
so there is no exchange between chips to leave out.)
"""
import pytest
import torch

from olabench.tests.tiny import base_cell, run_tiny

CELLS = ["sf10-report", "sf10-analyst"]


@pytest.mark.parametrize("w", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(w):
    out = run_tiny(w, control=True)
    assert out["correct"] is True
    limits = base_cell(w).limits
    assert any(v > limits[k] for k, v in out["control"].items()), out["control"]


def _unchanged(real):
    def step(members):
        return [m[3].clone() if m[2] is None else tuple(c.clone() for c in m[3:])
                for m in members]
    return step


def _altered(scale):
    """Every member's answer scaled where the launch produces it: a bank of
    the analysts' scan launches its slots as the members of one bundle, and
    the check samples some of the window's slots, which need not hold the
    first member of any launch."""
    def wrap(real):
        def step(members):
            return [o * scale if isinstance(o, torch.Tensor) else (o[0] * scale, *o[1:])
                    for o in real(members)]
        return step
    return wrap


@pytest.mark.parametrize("w", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(w, fault, monkeypatch):
    from repro_torch.kernels import fused_agg

    if fault == "half_batch":
        real_project = fused_agg.project

        def project(fs, cols):
            vals, w_, gids = real_project(fs, cols)
            w_ = w_.clone()
            w_[..., 1::2] = 0.0
            return (vals * 2).contiguous(), w_, gids
        monkeypatch.setattr(fused_agg, "project", project)
    else:
        limit = max(base_cell(w).limits.values())
        wrap = _unchanged if fault == "unchanged" else _altered(1 + 10 * max(limit, 1e-6))
        monkeypatch.setattr(fused_agg, "bundle_round_step", wrap(fused_agg.bundle_round_step))
    assert run_tiny(w)["correct"] is False


@pytest.mark.parametrize("w", ["sf10-report"])
def test_a_count_fault_is_not_correct(w):
    """The count fault the count limits were set against: round 0 scans one
    chunk fewer than the layout holds."""
    from olabench import run
    from olabench.calibrate import clear_first_chunk
    from olabench.tests.tiny import CPU, SEED, tiny_cell

    out = run.run_cell(tiny_cell(w), SEED, 0.5, False, CPU, plant=clear_first_chunk)
    assert out["correct"] is False and out["checks"]["count_gap"]["value"] > 1e-2
