"""The MoE family on the card (``repro_torch.models.moe`` and the
``attn_chunked`` block): smoke configs of llama4-maverick and grok-1
against the CPU port, two card runs of the backward bitwise equal, and a
resumed run bitwise an uninterrupted one.

Every test here is marked ``gpu`` and skips without a CUDA device; the file
imports no JAX:

    python -m pytest -q -m gpu tests/test_torch_moe_gpu.py

Tolerances: float32 weights, TF32 off — logits and grads within 1e-3 of
max|.| of the CPU port's, as ``chip_smoke.py``'s ``LM_CPU_TOL`` (float32
sums in another order); the routing (the experts each pair chose and which
pairs were kept) exact.  Repeated card runs and the resumed run: bitwise.
"""
import dataclasses

import pytest
import torch

from repro_torch import ckpt
from repro_torch import serve_step as SS
from repro_torch.configs import get_config
from repro_torch.data.tokens import token_batches
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.training import train_step as TS
from repro_torch.uda import tree_leaves, tree_map

MOE = ["llama4_maverick_400b_a17b", "grok_1_314b"]
TOL = 1e-3


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's MoE layer runs on the card here")
    return torch.device("cuda")


def _rel(a, b):
    return ((b.cpu() - a).abs().max() / a.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("factor", [1.25, 8.0], ids=["cap1.25", "cap8"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_mlp_on_the_card_matches_the_cpu_port(arch, factor):
    dev = _cuda()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(get_config(arch).smoke(), expert_capacity_factor=factor)
        model = TT.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
        p = {k: v[0] for k, v in model.params["layers"]["b0"]["mlp"].items()}
        x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(1))
        g, Tg, cap = TM.dispatch_shape(128, cfg.moe_groups, cfg)
        a = TM.route(p["router"], x.reshape(g, Tg, -1), cfg, cap)
        pd = {k: v.to(dev) for k, v in p.items()}
        b = TM.route(pd["router"], x.to(dev).reshape(g, Tg, -1), cfg, cap)
        assert torch.equal(a[1], b[1].cpu()) and torch.equal(a[2], b[2].cpu())
        assert torch.equal(a[3] > 0, b[3].cpu() > 0)
        (out, aux), (outd, auxd) = TM.moe_mlp(p, x, cfg, groups=cfg.moe_groups), \
            TM.moe_mlp(pd, x.to(dev), cfg, groups=cfg.moe_groups)
        assert _rel(out, outd) <= TOL and abs(auxd.item() - aux.item()) <= 1e-5 * aux.item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE)
def test_moe_smoke_model_on_the_card_matches_the_cpu_port(arch):
    """Prefill and decode steps across llama4's chunk boundary, and the
    grads of one loss, on the card against the CPU port; the card's
    backward twice, bitwise."""
    dev = _cuda()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config(arch).smoke()
        cpu = TT.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
        card = TT.Transformer(cfg, tree_map(lambda t: t.to(dev, copy=True), cpu.params))
        toks = next(token_batches(cfg, 2, 40, device="cpu"))[0]["tokens"]
        la, ca = SS.make_prefill(cfg, 44)(cpu, {"tokens": toks[:, :24]})
        lb, cb = SS.make_prefill(cfg, 44)(card, {"tokens": toks[:, :24].to(dev)})
        assert _rel(la, lb) <= TOL
        for t in range(24, 40):  # crosses attn_chunk = 32
            la, ca = SS.make_decode(cfg)(cpu, ca, toks[:, t], t)
            lb, cb = SS.make_decode(cfg)(card, cb, toks[:, t].to(dev), t)
            assert _rel(la, lb) <= TOL, t
        for x, y in zip(ca, cb):
            if "kpos" in x:
                assert torch.equal(x["kpos"], y["kpos"].cpu())
        cpu.requires_grad_(True)
        card.requires_grad_(True)
        batch = next(token_batches(cfg, 4, 64, device="cpu"))[0]
        (l0, _), g0 = TS.value_and_grad(cpu, cfg, batch)
        on = {k: v.to(dev) for k, v in batch.items()}
        (l1, _), g1 = TS.value_and_grad(card, cfg, on)
        (l2, _), g2 = TS.value_and_grad(card, cfg, on)
        assert abs(l1.item() - l0.item()) <= 1e-5 * abs(l0.item()) and torch.equal(l1, l2)
        for a, b, c in zip(tree_leaves(g0), tree_leaves(g1), tree_leaves(g2)):
            assert _rel(a, b) <= TOL and torch.equal(b, c)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE)
def test_resumed_moe_training_on_the_card_is_bitwise(arch, tmp_path):
    """4 Adafactor steps equal 2 steps, a save, a load onto the card and 2
    more, in bf16 with M=2 (the float32 accumulation) and remat="full"."""
    dev = _cuda()
    cfg = dataclasses.replace(get_config(arch).smoke(), train_microbatches=2, remat="full")
    step = TS.make_train_step(cfg, lr=3e-3)

    def run(model, opt, n, cursor):
        batches = token_batches(cfg, 4, 64, start=cursor, device=dev)
        for _ in range(n):
            batch, cursor = next(batches)
            model, opt, _ = step(model, opt, batch)
        return model, opt, cursor

    full = run(*TS.init_train_state(cfg, seed=1, dtype=torch.bfloat16, device=dev), 4, 0)
    model, opt, cursor = run(*TS.init_train_state(cfg, seed=1, dtype=torch.bfloat16, device=dev),
                             2, 0)
    ckpt.save_train_state(tmp_path / "r.ckpt", model.params, opt, 2, cursor)
    params, opt, _, cursor = ckpt.load_train_state(tmp_path / "r.ckpt", model.params, opt)
    resumed = run(TT.Transformer(cfg, params).requires_grad_(True), opt, 2, cursor)
    a = tree_leaves({"p": full[0].params, "o": full[1]})
    b = tree_leaves({"p": resumed[0].params, "o": resumed[1]})
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(bool(torch.isfinite(t.float()).all()) for t in a)
