"""The recurrent, encoder-decoder and vision families on the card: smoke
configs of recurrentgemma-9b, xlstm-125m, whisper-base and internvl2-1b
against the CPU port, two card runs of the backward bitwise equal, and
``mlstm_chunkwise`` against the sequential cell on the card.

Every test here is marked ``gpu`` and skips without a CUDA device; the file
imports no JAX:

    python -m pytest -q -m gpu tests/test_torch_recurrent_gpu.py

Tolerances: float64 weights — the prefill's logits and the decode steps'
within 1e-6 of max|.| of the CPU port's (the serving entry points return
float32 logits), every grad within 1e-9 of the largest (the same arithmetic,
summed in another order; xlstm's sLSTM ``bi`` grads are exactly 0 in exact
arithmetic, so no leaf-relative bound holds for them); float32 weights, TF32 off — the
logits within 1e-3 of the CPU port's (``chip_smoke.py``'s ``LM_CPU_TOL``)
on the families whose float32 forward lies within 1e-4 of float64 here
(recurrentgemma, internvl; xlstm's and whisper's smoke weights make float32
itself coarse, see ``tests/lm_parity.py``); the card's backward twice,
bitwise; ``mlstm_chunkwise`` within the reference's 1e-4 of the sequential
form.
"""
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch import serve_step as SS
from repro_torch.configs import get_config
from repro_torch.data.tokens import token_batches
from repro_torch.models import mlstm_chunked as MC
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as TT
from repro_torch.training import train_step as TS
from repro_torch.uda import tree_leaves, tree_map

ARCHS = ["recurrentgemma_9b", "xlstm_125m", "whisper_base", "internvl2_1b"]
F32_WELL = ("recurrentgemma_9b", "internvl2_1b")
TOL32, TOL64, LOGITS64 = 1e-3, 1e-9, 1e-6


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's recurrent models run on the card here")
    return torch.device("cuda")


def _rel(a, b):
    return ((b.double().cpu() - a.double()).abs().max() / a.double().abs().max()).item()


def _on(tree, dev, dtype):
    return tree_map(lambda t: t.detach().to(dev, dtype if t.is_floating_point() else t.dtype,
                                            copy=True), tree)


def _serve(model, batch, steps):
    cfg = model.cfg
    P = SS.prefix_len(cfg, batch)
    S = batch["tokens"].shape[1]
    logits, cache = SS.make_prefill(cfg, P + S + steps + 1)(model, batch)
    out = [logits]
    for t in range(steps):
        tok = torch.argmax(out[0], dim=-1).to(torch.int32)  # the same tokens on both devices
        logits, cache = SS.make_decode(cfg)(model, cache, tok, P + S + t)
        out.append(logits)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", [(a, torch.float64) for a in ARCHS]
                         + [(a, torch.float32) for a in F32_WELL],
                         ids=[f"{a}-f64" for a in ARCHS] + [f"{a}-f32" for a in F32_WELL])
def test_smoke_model_on_the_card_matches_the_cpu_port(arch, dtype):
    dev = _cuda()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config(arch).smoke()
        base = TT.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
        batch, _ = next(token_batches(cfg, 2, 64, seed=1, device="cpu"))  # two of the 32 windows
        cpu = TT.Transformer(cfg, _on(base.params, "cpu", dtype))
        card = TT.Transformer(cfg, _on(base.params, dev, dtype))
        tol = LOGITS64 if dtype == torch.float64 else TOL32
        a = _serve(cpu, _on(batch, "cpu", dtype), 4)
        b = _serve(card, _on(batch, dev, dtype), 4)
        for i, (x, y) in enumerate(zip(a, b)):
            assert _rel(x, y) <= tol, i
        cpu.requires_grad_(True)
        card.requires_grad_(True)
        (la, _), ga = TS.value_and_grad(cpu, cfg, _on(batch, "cpu", dtype))
        (lb, _), gb = TS.value_and_grad(card, cfg, _on(batch, dev, dtype))
        (lb2, _), gb2 = TS.value_and_grad(card, cfg, _on(batch, dev, dtype))
        assert torch.equal(lb, lb2) and all(torch.equal(x, y) for x, y in
                                            zip(tree_leaves(gb), tree_leaves(gb2)))
        if dtype == torch.float64:  # against the tree's largest grad: xlstm's sLSTM ``bi``
            ga, gb = tree_leaves(ga), tree_leaves(gb)  # grads are 0 exactly, rounding alone
            top = max(x.abs().max().item() for x in ga)
            assert max((y.cpu() - x).abs().max().item() for x, y in zip(ga, gb)) <= TOL64 * top
        assert abs(la.item() - lb.item()) <= tol * abs(la.item())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
def test_mlstm_chunkwise_on_the_card_matches_the_sequential_form():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    B, S, H, dh = 2, 256, 4, 64

    def draw(*shape):
        return torch.randn(shape, generator=g, device=dev)

    q, k, v = draw(B, S, H, dh), draw(B, S, H, dh) / math.sqrt(dh), draw(B, S, H, dh)
    li, lf = draw(B, S, H), F.logsigmoid(draw(B, S, H) + 1.0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        hc, (Cc, _, mc) = MC.mlstm_chunkwise(q, k, v, li, lf, chunk=64)
        hs, (Cs, _, ms) = R.mlstm_sequential(q, k, v, li, lf)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(hc, hs, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(Cc, Cs, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(mc, ms, rtol=1e-5, atol=1e-5)
