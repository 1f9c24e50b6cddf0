"""LM training on the card (``repro_torch.training``): a smoke train step
against the CPU port, and a resumed run bitwise an uninterrupted one.

Every test here is marked ``gpu`` and skips without a CUDA device; the file
imports no JAX:

    python -m pytest -q -m gpu tests/test_torch_train_gpu.py

Tolerances: float32 weights, TF32 off — grads within 1e-3 of max|grad|, as
``chip_smoke.py``'s ``LM_CPU_TOL`` (float32 sums in another order; on these
random weights the CPU port's own float32 grads lie up to 6.4e-5 of max|grad|
from its float64 ones, and each side carries its own); parameters after one AdamW step within 1e-5 of
max|param| plus 1% of an lr, except at most 0.1% of a leaf's entries (a
near-zero gradient whose sign rounds the other way moves its entry by up to
2·lr).  The resumed run: bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import ckpt
from repro_torch.configs import get_config
from repro_torch.data.tokens import token_batches
from repro_torch.models import transformer as TT
from repro_torch.training import train_step as TS
from repro_torch.uda import tree_leaves, tree_map

DENSE = ["smollm_135m", "deepseek_7b", "qwen3_32b", "nemotron_4_15b"]
LR = 1e-3


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's training runs on the card here")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", DENSE)
def test_smoke_train_step_on_the_card_matches_the_cpu_port(arch):
    dev = _cuda()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(get_config(arch).smoke(), train_microbatches=2)
        cpu, ocpu = TS.init_train_state(cfg, seed=0, dtype=torch.float32, device="cpu")
        card = TT.Transformer(cfg, tree_map(lambda t: t.detach().to(dev, copy=True), cpu.params))
        card.requires_grad_(True)
        ocard = tree_map(lambda t: t.to(dev, copy=True), ocpu)
        batch, _ = next(token_batches(cfg, 4, 32, device="cpu"))
        (la, _), ga = TS.value_and_grad(cpu, cfg, batch)
        (lb, _), gb = TS.value_and_grad(card, cfg, {k: v.to(dev) for k, v in batch.items()})
        assert abs(lb.item() - la.item()) <= 1e-5 * abs(la.item())
        for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
            assert (b.cpu() - a).abs().max().item() <= 1e-3 * a.abs().max().item()
        step = TS.make_train_step(cfg, lr=LR)
        cpu, ocpu, ma = step(cpu, ocpu, batch)
        card, ocard, mb = step(card, ocard, {k: v.to(dev) for k, v in batch.items()})
        assert mb["loss"].item() == pytest.approx(ma["loss"].item(), rel=1e-5)
        assert mb["grad_norm"].item() == pytest.approx(ma["grad_norm"].item(), rel=1e-4)
        for a, b in zip(tree_leaves(cpu.params), tree_leaves(card.params)):
            d = (b.detach().cpu() - a.detach()).abs()
            far = d > 1e-5 * a.abs().max().item() + 1e-2 * LR
            assert int(far.sum()) <= 1e-3 * d.numel() and d.max().item() <= 2 * LR
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_resumed_training_on_the_card_is_bitwise(dtype, tmp_path):
    """4 steps equal 2 steps, a save, a load onto the card and 2 more (M=2:
    the float32 accumulation path): the backward is deterministic there."""
    dev = _cuda()
    cfg = dataclasses.replace(get_config("deepseek_7b").smoke(), train_microbatches=2,
                              remat="full")
    step = TS.make_train_step(cfg, lr=3e-3)

    def run(model, opt, n, cursor):
        batches = token_batches(cfg, 4, 64, start=cursor, device=dev)
        for _ in range(n):
            batch, cursor = next(batches)
            model, opt, _ = step(model, opt, batch)
        return model, opt, cursor

    full = run(*TS.init_train_state(cfg, seed=1, dtype=dtype, device=dev), 4, 0)
    model, opt, cursor = run(*TS.init_train_state(cfg, seed=1, dtype=dtype, device=dev), 2, 0)
    ckpt.save_train_state(tmp_path / "r.ckpt", model.params, opt, 2, cursor)
    params, opt, _, cursor = ckpt.load_train_state(tmp_path / "r.ckpt", model.params, opt)
    assert params["embed"].device.type == "cuda" and params["embed"].dtype == dtype
    resumed = run(TT.Transformer(cfg, params).requires_grad_(True), opt, 2, cursor)
    a = tree_leaves({"p": full[0].params, "o": full[1]})
    b = tree_leaves({"p": resumed[0].params, "o": resumed[1]})
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert np.isfinite(full[0].params["embed"].float().sum().item())
