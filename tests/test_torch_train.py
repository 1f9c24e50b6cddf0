"""The port's LM training path (``repro_torch.training.train_step``,
``models.transformer.xent_loss`` and its remat, the trainable stacked
parameters) against the JAX reference on the CPU.

Weights and optimizer state are the reference's own (``init_params``,
``opt_init``), carried across by ``convert.lm_train_state_from_reference``;
tokens are numpy draws from a seed.  The four dense configs run at
``smoke()`` size.

Tolerances:
* ``shift_targets``: bitwise.
* ``xent_loss``: 1e-6 relative (float32 sums in another order).
* loss and grads of one ``value_and_grad`` in float32: the loss within
  1e-5 relative, each grad leaf within 1e-4 of max|ref grad|.  These random
  weights give near one-hot attention rows, which amplify float32 rounding:
  the port in float64 lies up to 6.4e-5 (of max|grad|) from the port in
  float32 on these inputs, so 1e-4 is about the float32 floor, not slack.
* ``make_train_step`` over 3 steps, each from the reference's state: the
  metrics within 1e-5 relative, but the grad norm within 1e-4 (the port's
  float32 grad norm lies up to 1e-5 from its float64 one on these models,
  and the reference's as far on its side); parameters within 1e-5 of
  max|param| plus 1% of one lr, except at most 0.1% of a leaf's entries,
  which may differ by up to 2·lr.  AdamW's first step is about lr·g/|g|,
  so where a gradient entry is near zero its sign — which rounding in
  either framework can flip — decides a whole lr.  The 1% of an lr is for
  the leaves that start at zero (LayerNorm biases: max|param| is then one
  lr or two): an update normalized by its gradient's own size carries that
  gradient's float32 error, measured up to 1.1e-3 of an lr on them.
* bf16: dtypes and shapes kept; the loss within 2e-2 relative.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.models import spec as RSPEC
from repro.models import transformer as RT
from repro.training import optimizer as RO
from repro.training import train_step as RTS
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.training import train_step as TS
from repro_torch.uda import tree_leaves

DENSE = ["smollm_135m", "deepseek_7b", "qwen3_32b", "nemotron_4_15b"]
B, S = 4, 32
LR = 1e-4  # make_train_step's default
GNORM_RTOL = 1e-4  # float32's own grad norm is up to 1e-5 off float64's here


def _cfgs(arch, **kw):
    return (dataclasses.replace(rget(arch).smoke(), **kw),
            dataclasses.replace(tget(arch).smoke(), **kw))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, dtype_name="float32"):
    cfg = rget(arch).smoke()
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    return RSPEC.init_params(RT.param_specs(cfg, dtype=jdt), jax.random.key(1))


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    a = np.asarray(a)
    return a.astype(np.float32).astype(np.float64)


def _state(arch, rcfg, tcfg, dtype_name="float32"):
    params = _ref_params(arch, dtype_name)
    opt = RO.opt_init(params, rcfg.optimizer)
    model, topt = convert.lm_train_state_from_reference(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt), tcfg, device="cpu")
    return params, opt, model, topt


# --------------------------------------------------------------------------- pieces

@pytest.mark.parametrize("extra", [0, 5], ids=["P=0", "P=5"])
def test_shift_targets_is_bitwise(extra):
    rcfg, tcfg = _cfgs("smollm_135m")
    toks = _tokens(rcfg, 0, (3, 11))
    rt, rm = RTS.shift_targets(rcfg, {"tokens": jnp.asarray(toks)}, 11 + extra)
    tt, tm = TS.shift_targets(tcfg, {"tokens": torch.from_numpy(toks)}, 11 + extra)
    assert tt.dtype == torch.int32 and tm.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))


@pytest.mark.parametrize("seq_chunk,masked", [(8, False), (7, False), (1024, True)],
                         ids=["chunk-divides", "chunk-lowered", "partly-masked"])
@pytest.mark.parametrize("arch", ["smollm_135m", "nemotron_4_15b"])  # tied, untied head
def test_xent_loss_matches(arch, seq_chunk, masked):
    rcfg, tcfg = _cfgs(arch)
    params = _ref_params(arch)
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, rcfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.6 if masked else np.ones((B, S))).astype(np.float32)
    want = float(RT.xent_loss(params, rcfg, jnp.asarray(x), jnp.asarray(tgt), jnp.asarray(mask),
                              seq_chunk=seq_chunk))
    got = TT.xent_loss(model, tcfg, torch.from_numpy(x), torch.from_numpy(tgt),
                       torch.from_numpy(mask), seq_chunk=seq_chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * abs(want)


def test_xent_loss_keeps_one_chunk_of_logits():
    """Under autograd the graph keeps each chunk's inputs (x's slice, the
    targets, the mask, a view of the head), never logits: every saved
    tensor is smaller than one chunk's [B, c, V] logits."""
    _, tcfg = _cfgs("smollm_135m")
    model = TT.init_model(tcfg, seed=0, dtype=torch.float32, device="cpu").requires_grad_(True)
    x = torch.randn(B, 64, tcfg.d_model, requires_grad=True)
    tgt = torch.zeros(B, 64, dtype=torch.int32)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = TT.xent_loss(model, tcfg, x, tgt, torch.ones(B, 64), seq_chunk=32)
    loss.backward()
    assert saved and max(saved) < B * 32 * tcfg.vocab_padded
    assert x.grad is not None and model.params["embed"].grad is not None


def test_grad_dtype_boundary_is_identity_with_the_primal_cotangent_dtype():
    x = torch.randn(3, 4, dtype=torch.bfloat16, requires_grad=True)
    y = TS.grad_dtype_boundary(x)
    assert torch.equal(y, x) and y.dtype == torch.bfloat16
    (y.to(torch.float32) * 3.0).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    (g,) = torch.autograd.grad(TS.grad_dtype_boundary(x), x, torch.ones(3, 4))
    assert g.dtype == torch.bfloat16 and torch.equal(g, torch.ones(3, 4, dtype=torch.bfloat16))


@pytest.mark.parametrize("dt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_silu_grad_is_the_references_and_finite_where_exp_overflows(dt):
    """``jax.grad`` of ``jax.nn.silu``: the logistic's own derivative, finite
    below -88 where ``exp(-x)`` overflows (autograd through ``1 / (1 +
    exp(-x))`` gives NaN there: full-width bf16 MLPs reach such inputs)."""
    x = np.concatenate([np.linspace(-300, 300, 6001),
                        np.random.default_rng(0).normal(size=4000) * 4]).astype(np.float32)
    xt = torch.from_numpy(x).to(dt[1]).requires_grad_(True)
    (g,) = torch.autograd.grad(TL.mlp_act(xt, "silu").sum(), xt)
    want = _np(jax.grad(lambda a: jnp.sum(jax.nn.silu(a)))(jnp.asarray(x, dt[0])))
    assert g.dtype == dt[1] and bool(torch.isfinite(g).all())
    np.testing.assert_allclose(_np(g), want, rtol=2.0 ** -7 if dt[1] == torch.bfloat16 else 1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------------- loss and grads

@pytest.mark.parametrize("arch", DENSE)
def test_value_and_grad_matches_in_float32(arch):
    rcfg, tcfg = _cfgs(arch)
    params, _, model, _ = _state(arch, rcfg, tcfg)
    toks = _tokens(rcfg, 0, (B, S))
    (rl, rce), rg = jax.value_and_grad(RTS.loss_fn, has_aux=True)(
        params, rcfg, {"tokens": jnp.asarray(toks)})
    (tl, tce), tg = TS.value_and_grad(model, tcfg, {"tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(rl)) <= 1e-5 * abs(float(rl))
    assert abs(float(tce) - float(rce)) <= 1e-5 * abs(float(rce))
    ref_leaves, _ = jax.tree.flatten_with_path(rg)
    got = tree_leaves(tg)
    assert len(got) == len(ref_leaves)
    for (path, r), g in zip(ref_leaves, got):
        r, g = _np(r), _np(g)
        assert r.shape == g.shape, jax.tree_util.keystr(path)
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ["smollm_135m", "qwen3_32b"])
def test_remat_policies_give_bitwise_equal_grads(arch):
    """``remat`` changes what the backward keeps, never the values."""
    toks = torch.from_numpy(_tokens(rget(arch).smoke(), 2, (B, S)))
    out = {}
    for policy in ("none", "full", "dots"):
        _, tcfg = _cfgs(arch, remat=policy)
        model = TT.init_model(tcfg, seed=3, dtype=torch.float32, device="cpu").requires_grad_(True)
        (loss, _), g = TS.value_and_grad(model, tcfg, {"tokens": toks})
        out[policy] = (loss, tree_leaves(g))
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[policy][1], out["none"][1])), policy


# --------------------------------------------------------------------------- the train step

def _params_close(got_model, want_params, lr):
    got = jax.tree.flatten_with_path(convert.lm_params_to_numpy(got_model))[0]
    want = jax.tree.flatten_with_path(want_params)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, r), (_, g) in zip(want, got):
        r, g = _np(r), _np(g)
        d = np.abs(g - r)
        far = d > 1e-5 * np.abs(r).max() + 1e-2 * lr
        assert far.sum() <= 1e-3 * d.size, (jax.tree_util.keystr(path), int(far.sum()), d.size)
        assert d.max() <= 2 * lr, jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch,micro,batch,opt", [
    *[(a, m, 4, "adamw") for a in DENSE for m in (1, 2, 4)],
    ("smollm_135m", 4, 6, "adamw"),       # 6 % 4: the loop lowers M to 3
    ("nemotron_4_15b", 2, 4, "adafactor"),
], ids=lambda v: str(v))
def test_train_step_matches_over_three_steps(arch, micro, batch, opt):
    """Three steps, each from the reference's state after the one before
    (carried across again), so that a rounding that flips an update in one
    framework does not carry into the next step: these random weights turn
    a parameter moved by 1e-4 into a grad norm 5e-5 (relative) away."""
    rcfg, tcfg = _cfgs(arch, train_microbatches=micro, optimizer=opt)
    params = _ref_params(arch)
    ropt = RO.opt_init(params, rcfg.optimizer)
    rstep = jax.jit(RTS.make_train_step(rcfg, lr=LR))
    tstep = TS.make_train_step(tcfg, lr=LR)
    for i in range(3):
        model, topt = convert.lm_train_state_from_reference(
            jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, ropt), tcfg, device="cpu")
        toks = _tokens(rcfg, 10 + i, (batch, S))
        params, ropt, rm = rstep(params, ropt, {"tokens": jnp.asarray(toks)})
        model, topt, tm = tstep(model, topt, {"tokens": torch.from_numpy(toks)})
        assert set(tm) == set(rm)
        for k in rm:
            tol = GNORM_RTOL if k == "grad_norm" else 1e-5
            assert tm[k].dtype == torch.float32 and tm[k].shape == ()
            assert abs(float(tm[k]) - float(rm[k])) <= tol * abs(float(rm[k])), (i, k)
        assert int(topt.step) == int(ropt.step) == i + 1 and topt.step.dtype == torch.int32
        _params_close(model, params, LR)
    assert float(tm["num_micro"]) == (3 if batch == 6 else micro)


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_step_keeps_dtypes_and_shapes(arch):
    rcfg, tcfg = _cfgs(arch)
    params, ropt, model, topt = _state(arch, rcfg, tcfg, "bfloat16")
    shapes = [(t.shape, t.dtype) for t in tree_leaves(model.params)]
    toks = _tokens(rcfg, 4, (B, S))
    _, _, rm = jax.jit(RTS.make_train_step(rcfg, lr=LR))(params, ropt, {"tokens": jnp.asarray(toks)})
    model, topt, tm = TS.make_train_step(tcfg, lr=LR)(model, topt, {"tokens": torch.from_numpy(toks)})
    assert [(t.shape, t.dtype) for t in tree_leaves(model.params)] == shapes
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(model.params))
    assert all(t.dtype == torch.float32 for t in tree_leaves(topt.master))
    assert abs(float(tm["loss"]) - float(rm["loss"])) <= 2e-2 * abs(float(rm["loss"]))


def test_init_train_state_is_trainable_and_serving_builds_no_graph():
    _, tcfg = _cfgs("smollm_135m")
    model, opt = TS.init_train_state(tcfg, seed=0, dtype=torch.float32, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    assert model.params["layers"]["b0"]["wq"].shape[0] == tcfg.num_layers  # stacked leaves
    assert tree_leaves(opt.master)[0] is not tree_leaves(model.params)[0]
    toks = torch.from_numpy(_tokens(rget("smollm_135m").smoke(), 5, (2, 8)))
    x, _, cache = model.forward({"tokens": toks}, cache_len=12)
    assert not x.requires_grad and not cache[0]["k"].requires_grad
    logits, _ = model.decode_step(toks[:, 0], cache, 8)
    assert not logits.requires_grad and logits.grad_fn is None
    assert not model.example_nll(toks).requires_grad
    x, _, _ = model.forward({"tokens": toks})
    assert x.requires_grad  # the training forward does build one


def test_grad_floor_tool_runs_on_a_cut_model(capsys):
    """``tools/lm_grad_floor.py`` (float32 against float64 grads of the
    port's LM), on a 2-layer cut at full width and 16 tokens."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "lm_grad_floor.py"
    spec = importlib.util.spec_from_file_location("lm_grad_floor", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    worst = tool.main(["--layers", "2", "--batch", "1", "--seq", "16"])
    assert 0.0 < worst < 1.0
    assert "layers=2 tokens=1x16" in capsys.readouterr().out
