"""The plan auditor (``repro_torch.audit``) on a card: every smoke plan of
``audit.main`` audited with ``ALL_CHECKS`` where its dry step launches the
port's kernels — the report ``ok``, ``DISPATCHES == LAUNCHES`` after each
audit (the plain route's count is the CUDA route's), the caller's launch
counts unchanged by the audit, and the footprint's peak device bytes
reported (None on the CPU) within 4 round-slices.

Every test here is marked ``gpu`` and skips without a CUDA device; the file
imports no JAX:

    python -m pytest -q -m gpu tests/test_torch_audit_gpu.py
"""
import pytest
import torch

import repro_torch as T
from repro_torch import audit as AU
from repro_torch.data import source as DS
from repro_torch.kernels import _runtime as RT

ROWS, ROUNDS = 20_000, 4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def smoke():
    dev = _cuda()
    shards = AU._smoke_data(ROWS, 4, 128, ROUNDS, device=dev)
    plans = {n: (q, emit, None) for n, q, emit in AU._smoke_plans(ROWS, device=dev)}
    np_shards = {k: v.cpu().numpy() for k, v in shards.items()}
    plans["encoded-bundle"] = (plans["bundle"][0], "kernel", DS.EncodedSource.from_shards(
        np_shards, AU.smoke_encodings(np_shards)))
    plans["q1-kernel-cols"] = (plans["q1"][0].with_(fused=None), "kernel", None)
    return dev, shards, plans


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["q6", "q1", "bundle", "q3-join", "encoded-bundle",
                                  "q1-kernel-cols"])
def test_smoke_plan_audits_on_the_card(name, smoke):
    dev, shards, plans = smoke
    q, emit, src = plans[name]
    RT.reset_launch_counts()
    RT.LAUNCHES["group_agg"] = RT.DISPATCHES["group_agg"] = 7  # a caller's counts
    rep = AU.audit_plan(q, shards if src is None else src, rounds=ROUNDS, emit=emit,
                        device=dev, checks=AU.ALL_CHECKS)
    assert rep.ok, rep.summary()
    assert rep.plan["backend"] == "cuda"
    assert RT.launch_counts() == RT.dispatch_counts()
    assert RT.launch_counts() == {**dict.fromkeys(RT.LAUNCHES, 0), "group_agg": 7}
    fp = rep.result("o_slice_footprint")
    assert fp.passed and fp.data["peak_bytes"] is not None
    assert 0 < fp.data["peak_bytes"] <= AU.PEAK_SLICES * fp.data["slice_bytes"]
    kernel = rep.result("fused_single_dispatch" if rep.plan["path"] == "kernel_fused"
                        else "single_kernel_dispatch")
    assert kernel.passed if emit == "kernel" else kernel.skipped


@pytest.mark.gpu
def test_the_dry_step_launches_what_it_dispatches(smoke):
    """A session's launches equal its dispatches on the card, and an
    audited session launches as the unaudited one does."""
    dev, shards, plans = smoke
    q, emit, _ = plans["bundle"]
    spec = T.QuerySpec(q, rounds=ROUNDS, emit=emit)
    RT.reset_launch_counts()
    sess = T.Session(spec, shards, device=dev, audit=True)
    assert RT.launch_counts() == dict.fromkeys(RT.LAUNCHES, 0)
    sess.run()
    torch.cuda.synchronize()
    assert RT.launch_counts() == RT.dispatch_counts()
    assert RT.LAUNCHES["fused_round_step/bundle"] == ROUNDS  # the whole scan: K1 a round
    RT.reset_launch_counts()


@pytest.mark.gpu
def test_audit_service_on_the_card(smoke):
    dev, shards, _ = smoke
    RT.reset_launch_counts()
    rep = AU.audit_service(AU.smoke_family(), shards, rounds=ROUNDS, device=dev)
    assert rep.ok and rep.plan["backend"] == "cuda", rep.summary()
    assert RT.launch_counts() == RT.dispatch_counts() == dict.fromkeys(RT.LAUNCHES, 0)
