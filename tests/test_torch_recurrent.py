"""The port's recurrent mixers (``repro_torch.models.recurrent``,
``models.mlstm_chunked`` and the ``rglru``/``mlstm``/``slstm`` blocks of
``models.transformer``) against the JAX reference on the CPU:
recurrentgemma-9b (rglru, rglru, attn_chunked with a sliding window) and
xlstm-125m (mlstm ×3, slstm) at ``smoke()`` size, xlstm in both
``mlstm_form``s.

Tolerances:
* each block alone, float32, parameters from the reference's ``init_params``
  with every 1-D leaf moved off its constant init (so the gates are not
  trivial): the output within 1e-5 of max|out|, each state leaf within 1e-5
  of its max|.| (float32 sums in another order; measured up to 1.7e-6);
  the zero states equal.
* ``linear_scan`` (the doubling scan) within 1e-6 of a step-by-step loop.
* ``mlstm_chunkwise`` over ``tests/test_mlstm_chunked.py``'s shapes: the
  reference's own tolerances against the sequential form — h and C within
  1e-4 (rtol and atol), m within 1e-5, the extreme-gate case 5e-4, the
  gradients 2e-3 — both against the reference's ``mlstm_chunkwise`` and
  against the port's sequential form.
* the models: ``tests/lm_parity.py``'s (the dense and MoE families'
  tolerances; xlstm's smoke weights make float32 itself coarse, so its
  comparisons hold the port in float64 to the reference in float64,
  stated there).
* a prefill of 1 or 2 tokens followed by decode steps: within 1e-9 of
  max|logit| of decoding every token from ``init_cache``, in float64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as LP
from repro.configs import get_config as rget
from repro.models import mlstm_chunked as RMC
from repro.models import recurrent as RR
from repro.models import spec as RSPEC
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch import serve_step as SS
from repro_torch.configs import get_config as tget
from repro_torch.models import mlstm_chunked as TMC
from repro_torch.models import recurrent as TR
from repro_torch.models import transformer as TT
from repro_torch.uda import tree_leaves

ARCHS = [("recurrentgemma_9b", {}), ("xlstm_125m", {}),
         ("xlstm_125m", {"mlstm_form": "sequential"})]
IDS = ["recurrentgemma", "xlstm-chunkwise", "xlstm-sequential"]


def _t(tree):
    return convert._param_tree(jax.tree.map(np.asarray, tree), torch.device("cpu"))


# --------------------------------------------------------------------------- blocks

@pytest.mark.parametrize("kind,arch,form", [
    ("rglru", "recurrentgemma_9b", "chunkwise"), ("mlstm", "xlstm_125m", "chunkwise"),
    ("mlstm", "xlstm_125m", "sequential"), ("slstm", "xlstm_125m", "chunkwise")],
    ids=["rglru", "mlstm-chunkwise", "mlstm-sequential", "slstm"])
def test_block_train_decode_and_state_match_in_float32(kind, arch, form):
    cfg = dataclasses.replace(rget(arch).smoke(), mlstm_form=form)
    tcfg = dataclasses.replace(tget(arch).smoke(), mlstm_form=form)
    p = RSPEC.init_params(getattr(RR, kind + "_specs")(cfg, jnp.float32), jax.random.key(0))
    rng = np.random.default_rng(5)
    p = jax.tree.map(lambda a: a + 0.3 * jnp.asarray(rng.normal(size=a.shape), a.dtype)
                     if a.ndim == 1 else a, p)
    tp = _t(p)
    x = np.random.default_rng(0).normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    ro, rst = getattr(RR, kind + "_train")(p, jnp.asarray(x), cfg)
    to, tst = getattr(TR, kind + "_train")(tp, torch.from_numpy(x), tcfg)
    assert to.dtype == torch.float32 and LP.rel(to, ro) <= 1e-5
    assert set(tst) == set(rst)
    for k in rst:
        assert tst[k].dtype == torch.float32 and LP.rel(tst[k], rst[k]) <= 1e-5, k
    x1 = np.random.default_rng(1).normal(size=(2, cfg.d_model)).astype(np.float32)
    ro, rst2 = getattr(RR, kind + "_decode")(p, jnp.asarray(x1), rst, cfg)
    to, tst2 = getattr(TR, kind + "_decode")(tp, torch.from_numpy(x1),
                                             {k: torch.from_numpy(np.array(v)) for k, v in rst.items()},
                                             tcfg)
    assert LP.rel(to, ro) <= 1e-5
    for k in rst2:
        assert LP.rel(tst2[k], rst2[k]) <= 1e-5, k
    zeros = getattr(TR, kind + "_state")(tcfg, 3, "cpu")
    for k, v in getattr(RR, kind + "_state")(cfg, 3).items():
        assert zeros[k].dtype == torch.float32 and zeros[k].shape == v.shape and not zeros[k].any()


@pytest.mark.parametrize("S", [1, 2, 5, 64, 100])
def test_linear_scan_is_the_recurrence(S):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, S, 3)).astype(np.float32))
    h, want = torch.zeros(2, 3), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = TR.linear_scan(a, b)
    assert (got - torch.stack(want, 1)).abs().max() <= 1e-6 * torch.stack(want, 1).abs().max()


def _mlstm_inputs(B, S, H, dh, seed=0, gate_scale=1.0):
    """``tests/test_mlstm_chunked.py``'s inputs."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    k = (rng.normal(size=(B, S, H, dh)) / np.sqrt(dh)).astype(np.float32)
    v = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    li = (rng.normal(size=(B, S, H)) * gate_scale).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(jnp.asarray(rng.normal(size=(B, S, H)) + 1.0)), np.float32)
    return q, k, v, li, lf


@pytest.mark.parametrize("chunk", [8, 32, 64])
@pytest.mark.parametrize("shape", [(2, 64, 2, 8), (1, 96, 3, 16)])
def test_mlstm_chunkwise_matches_the_reference_and_the_sequential_form(chunk, shape):
    B, S, H, dh = shape
    ins = _mlstm_inputs(B, S, H, dh, seed=chunk + S)
    rh, (rC, _, rm) = RMC.mlstm_chunkwise(*map(jnp.asarray, ins), chunk=chunk)
    th, (tC, tn, tm) = TMC.mlstm_chunkwise(*map(torch.from_numpy, ins), chunk=chunk)
    sh, (sC, sn, sm) = TR.mlstm_sequential(*map(torch.from_numpy, ins))
    for got, want in ((th, rh), (th, sh)):
        np.testing.assert_allclose(LP.np64(got), LP.np64(want), rtol=1e-4, atol=1e-4)
    for got, want in ((tC, rC), (tC, sC)):
        np.testing.assert_allclose(LP.np64(got), LP.np64(want), rtol=1e-4, atol=1e-4)
    for got, want in ((tm, rm), (tm, sm)):
        np.testing.assert_allclose(LP.np64(got), LP.np64(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), sn.numpy(), rtol=1e-4, atol=1e-4)
    assert TMC.chunk_size(S, 128) == min(128, S) and TMC.chunk_size(100, 32) == 25


def test_mlstm_chunkwise_extreme_gates_stable():
    ins = _mlstm_inputs(1, 64, 2, 8, seed=9, gate_scale=8.0)
    th, _ = TMC.mlstm_chunkwise(*map(torch.from_numpy, ins), chunk=16)
    sh, _ = TR.mlstm_sequential(*map(torch.from_numpy, ins))
    rh, _ = RMC.mlstm_chunkwise(*map(jnp.asarray, ins), chunk=16)
    assert bool(torch.isfinite(th).all())
    np.testing.assert_allclose(th.numpy(), sh.numpy(), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), rtol=5e-4, atol=5e-4)


def test_mlstm_chunkwise_gradients_match():
    q, k, v, li, lf = map(torch.from_numpy, _mlstm_inputs(1, 32, 2, 8, seed=3))
    grads = []
    for fn in (lambda q: TR.mlstm_sequential(q, k, v, li, lf)[0],
               lambda q: TMC.mlstm_chunkwise(q, k, v, li, lf, chunk=8)[0]):
        qq = q.clone().requires_grad_(True)
        h = fn(qq)
        (g,) = torch.autograd.grad(torch.sum(h * h), qq)
        grads.append(g)
    rq, rk, rv, rli, rlf = map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy(), li.numpy(),
                                             lf.numpy()))
    rg = jax.grad(lambda q: jnp.sum(RMC.mlstm_chunkwise(q, rk, rv, rli, rlf, chunk=8)[0] ** 2))(rq)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(rg), rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------------------- the models

@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m"])
def test_param_specs_are_the_reference_tree_with_float32_leaves(arch):
    """At smoke size (recurrentgemma: one group, no tail)."""
    leaves = dict(LP.check_param_specs(arch, full=False))
    f32 = {p for p, s in leaves.items() if s.dtype == torch.float32}
    if arch == "recurrentgemma_9b":
        assert f32 == {"layers/b0/lam", "layers/b1/lam"}
    else:
        assert f32 == {f"layers/b{j}/b_if" for j in range(3)} | {f"layers/b3/b{g}" for g in "zifo"}


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m"])
def test_lm_params_from_reference_keeps_the_float32_leaves_of_a_bf16_model(arch):
    params = RSPEC.init_params(RT.param_specs(rget(arch).smoke(), dtype=jnp.bfloat16),
                               jax.random.key(0))
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                             tget(arch).smoke(), device="cpu")
    ref, mine = jax.tree.flatten_with_path(params)[0], tree_leaves(model.params)
    assert len(ref) == len(mine)
    for (path, r), t in zip(ref, mine):
        assert str(t.dtype).removeprefix("torch.") == r.dtype.name, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(LP.np64(t), LP.np64(r))
    assert {t.dtype for t in mine} == {torch.float32, torch.bfloat16}


@pytest.mark.parametrize("arch,kw", ARCHS, ids=IDS)
def test_forward_logits_match_in_float32(arch, kw):
    LP.check_forward(arch, **kw)


@pytest.mark.parametrize("arch,kw", ARCHS, ids=IDS)
def test_prefill_and_decode_match_in_float32(arch, kw):
    """recurrentgemma's smoke window is 32: a prompt of 64 fills its ring
    past the window, and the decode steps go on across it."""
    LP.check_prefill_and_decode(arch, prompt=64 if arch == "recurrentgemma_9b" else 20, **kw)


@pytest.mark.parametrize("arch,kw", ARCHS, ids=IDS)
def test_greedy_generate_tokens_equal_in_float32(arch, kw):
    LP.check_greedy(arch, **kw)


@pytest.mark.parametrize("S", [12, 64])
@pytest.mark.parametrize("arch,kw", ARCHS[:2], ids=IDS[:2])
def test_incremental_decode_matches_forward(arch, kw, S):
    LP.check_incremental(arch, S=S, **kw)


@pytest.mark.parametrize("arch,kw", ARCHS, ids=IDS)
def test_value_and_grad_matches_in_float32(arch, kw):
    LP.check_value_and_grad(arch, **kw)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m"])
def test_train_step_matches_over_three_steps(arch):
    LP.check_train_steps(arch)


@pytest.mark.parametrize("arch,kw", ARCHS, ids=IDS)
def test_remat_policies_give_bitwise_equal_grads(arch, kw):
    LP.check_remat_bitwise(arch, **kw)


def test_bf16_serving_holds_to_its_own_forward():
    """recurrentgemma only: xlstm's smoke weights (fan-in 1) leave nothing
    for bf16 to hold — its bf16 forward lies 0.83 of max|logit| from its
    float32 forward on the same draws."""
    LP.check_bf16_serving("recurrentgemma_9b")


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m"])
def test_short_prefill_then_decode_equals_decoding_every_token(arch, n):
    """The reference's prefill keeps ``u_in[:, -3:]`` as the conv state, so
    after a prompt of 1 or 2 tokens its next decode fails; the port pads the
    missing rows with zeros in front (the zero initial state): a prefill of
    ``n`` tokens and decode steps after it equal decoding every token from
    ``init_cache``.  In float64 (the prefill's chunkwise mLSTM and conv sum
    in another order than the decode's steps), so that float32 rounding,
    which xlstm's smoke weights amplify, does not hide the state."""
    cfg = tget(arch).smoke()
    m = LP.f64(TT.init_model(cfg, seed=6, dtype=torch.float32, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8)))
    _, cache = SS.make_prefill(cfg, 8)(m, {"tokens": toks[:, :n]})
    conv = [c["conv"] for c, lt in zip(cache, cfg.layer_types()) if "conv" in c]
    assert conv and all(c.shape[1] == TR.TAPS - 1 and not c[:, :TR.TAPS - 1 - n].any() for c in conv)
    want = LP.f64(m.init_cache(2, 8))
    for t in range(8):
        lw, want = m.decode_step(toks[:, t], want, t)
        if t >= n:
            lg, cache = m.decode_step(toks[:, t], cache, t)
            assert (lg - lw).abs().max() <= 1e-9 * lw.abs().max(), t


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m"])
def test_decode_step_keeps_each_state_dict(arch):
    """``decode_step`` updates a recurrent layer's state in its own dict, so
    ``convert.lm_cache_to_numpy`` and ``greedy_generate`` see the new state
    through the same objects."""
    cfg = tget(arch).smoke()
    m = TT.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    cache = m.init_cache(2, 8)
    ids = [id(c) for c in cache]
    before = [dict(c) for c in cache]
    _, out = m.decode_step(torch.zeros(2, dtype=torch.int32), cache, 0)
    assert out is cache and [id(c) for c in out] == ids
    for c, b, lt in zip(cache, before, cfg.layer_types()):
        if lt in ("rglru", "mlstm", "slstm"):
            assert all(c[k] is not b[k] for k in c) and c["h" if lt != "mlstm" else "C"].any()


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m"])
def test_serve_step_main_runs_on_the_cpu(arch, capsys):
    LP.check_serve_main(arch, capsys)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m"])
def test_train_main_runs_and_resumes_on_the_cpu(arch, tmp_path, capsys):
    LP.check_train_main(arch, tmp_path, capsys)
