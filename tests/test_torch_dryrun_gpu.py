"""The dry run against the card (``repro_torch.dryrun``, ``repro_torch.cost``)
at a small size: on a (data=1, model=1) mesh the dry run's
``argument_bytes`` equal the bytes of the same parameters, optimizer state,
batch and cache allocated on the card, and the flops a real step dispatches
there equal the loop-scaled ``meta`` count, exactly; and
``cost.trace_summary`` reads a real ``torch.profiler`` trace of one K1
launch.

Every test here is marked ``gpu`` and skips without a CUDA device; the file
imports no JAX:

    python -m pytest -q -m gpu tests/test_torch_dryrun_gpu.py
"""
import dataclasses
import types

import pytest
import torch

from repro_torch import cost as C
from repro_torch import dryrun as D
from repro_torch.configs import get_config

ONE = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step runs on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape,batch,cut", [
    ("smollm_135m", "train_4k", 4, {"train_microbatches": 4}),   # 4 trips, 3 counted
    ("xlstm_125m", "train_4k", 1, {"num_layers": 4}),             # one sLSTM layer
    ("qwen3_32b", "decode_32k", 2, {"num_layers": 2})])
def test_one_card_cell_bytes_and_flops_equal_the_meta_count(arch, shape, batch, cut):
    dev = _cuda()
    cfg = dataclasses.replace(get_config(arch), **cut)
    cell = D.build_cell(arch, shape, ONE, cfg=cfg, batch=batch)
    c_meta, mem, _ = D.measure(cell, ONE)
    args = D.materialize(cell, dev)
    held = list(C._tensors(tuple(args[1:]))) + list(args[0].parameters())
    assert mem["argument_bytes"] == sum(t.untyped_storage().nbytes() for t in held)
    _, c_card = C.count(cell.step, *args)
    torch.cuda.synchronize()
    assert c_card.cost.flops == c_meta.cost.flops > 0
    assert c_card.matmul_flops() == c_meta.matmul_flops()


@pytest.mark.gpu
def test_trace_summary_reads_a_real_trace_of_one_k1_launch():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import fused_agg as FK

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    vals = torch.rand((2, 64, 1024, 1), generator=g, device=dev)
    w = torch.ones((2, 64, 1024), device=dev)
    carry = torch.zeros((2, 3), device=dev)
    FK.scalar_round_step(vals, w, carry)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        FK.scalar_round_step(vals, w, carry)
        torch.cuda.synchronize()
    s = C.trace_summary(prof)
    names = [k for k, _, _ in s["top"]]
    assert s["kernels"] >= 1 and any("pf_" in k or "scalar" in k for k in names), names
    assert s["device_ms"] > 0 and 0 < s["busy_share"] <= 1
    assert s["busy_ms"] <= s["device_ms"] + 1e-9
    # what chip_smoke.py's readers took from key_averages before they used it
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    assert s["kernels"] == sum(e.count for e in evs)
    assert s["device_ms"] == pytest.approx(sum(e.self_device_time_total for e in evs) / 1e3)
