"""The port's MoE family and chunked local attention (``repro_torch.models.moe``,
the ``attn_chunked`` block and its ring cache in ``models.transformer``)
against the JAX reference on the CPU, for llama4-maverick (top-1 of 4
experts at ``smoke()`` size, three ``attn_chunked`` layers and one global
``attn`` layer, ``attn_chunk=32``) and grok-1 (top-2, softcapped logits).

Weights are the reference's own ``init_params``, carried across by
``convert.lm_params_from_reference`` (the router and the expert leaves
included); tokens and activations are numpy draws from a seed.

Tolerances:
* routing: the experts chosen, the ranks within each expert and the keep
  mask (which pairs are kept) exact; the kept pairs' gates within 1e-5
  relative.  A top-1 gate is exactly 1; a top-2 gate ``p1 / (p1 + p2)``
  moves with the router's logits, which reach |18| here (the fan-in rule
  draws the stacked router at std 1/sqrt(2), not 1/sqrt(d)), where float32
  products summed in another order move a logit by up to 4e-6 (1.9e-6 the
  reference, 3.7e-6 the port, each against float64): up to 5e-6 on a gate;
  the output within 1e-5 of max|out|, ``aux`` within 1e-6 relative
  (float32 sums in another order).
* the model in float32: logits within 1e-4 of max|logit| (the dense
  family's ``test_torch_lm.py`` tolerance), ``aux`` within 1e-5 relative;
  the bf16 K/V caches: each entry at most one ulp off, and at most 0.5% of
  the written entries (a ring has few empty slots to dilute the count, as
  the dense family's padded caches do); a float32 K/V value within its
  rounding error of a bf16 boundary rounds either way, and the port's
  prefill of these smoke models, dense ones included, flips 0.1–0.25% of
  a layer's written entries (smollm-135m 0.17%, llama4 0.23%, grok 0.22%
  at 20–64 tokens; before any expert: llama4's first layer flips too).
  The ring's ``kpos`` exact; greedy tokens equal.
* incremental decode against the forward: 2e-3 of max|logit|, at a
  capacity factor of 8.0, which drops nothing (the reference's own
  ``test_prefill_decode_consistency`` raises it for the same reason): a
  forward over B·S tokens and a decode over B tokens fill the experts
  differently, so under drops they differ by design.
* training: ``test_torch_train.py``'s tolerances (metrics 1e-5, the grad
  norm 1e-4, parameters within 1e-5 of max|param| plus 1% of an lr except
  0.1% of a leaf's entries, which may be up to 2·lr off).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.models import moe as RM
from repro.models import spec as RSPEC
from repro.models import transformer as RT
from repro.serving import serve_step as RSS
from repro.training import optimizer as RO
from repro.training import train_step as RTS
from repro_torch import convert
from repro_torch import serve_step as SS
from repro_torch import train as TRAIN
from repro_torch.configs import get_config as tget
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.training import train_step as TS
from repro_torch.uda import tree_leaves

MOE = ["llama4_maverick_400b_a17b", "grok_1_314b"]
F32_TOL, INCR_TOL = 1e-4, 2e-3
FLIP_FRACTION = 5e-3
LR = 1e-4


def _cfgs(arch, **kw):
    return (dataclasses.replace(rget(arch).smoke(), **kw),
            dataclasses.replace(tget(arch).smoke(), **kw))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return RSPEC.init_params(RT.param_specs(rget(arch).smoke(), dtype=jnp.float32),
                             jax.random.key(1))


def _model(arch, **kw):
    rcfg, tcfg = _cfgs(arch, **kw)
    params = _ref_params(arch)
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return rcfg, tcfg, params, model


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().float() if a.is_floating_point() else a.detach()
        return a.numpy().astype(np.float64)
    a = np.asarray(a)
    return a.astype(np.float32).astype(np.float64) if a.dtype.name == "bfloat16" else a.astype(np.float64)


def _rel(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / np.abs(w).max())


# --------------------------------------------------------------------------- the dispatch

@pytest.mark.parametrize("case", ["random", "one-expert", "distinct", "batched"])
def test_ranks_within_expert_bitwise(case):
    rng = np.random.default_rng(7)
    E = 8
    eids = {"random": rng.integers(0, E, 37),
            "one-expert": np.full(23, 5),
            "distinct": rng.permutation(E),
            "batched": rng.integers(0, E, (3, 19))}[case].astype(np.int32)
    got = TM._ranks_within_expert(torch.from_numpy(eids).long(), E)
    want = np.asarray(jax.vmap(lambda e: RM._ranks_within_expert(e, E))(
        jnp.asarray(eids.reshape(-1, eids.shape[-1])))).reshape(eids.shape)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "one-expert":
        np.testing.assert_array_equal(got.numpy(), np.arange(23))
    if case == "distinct":
        assert not got.any()


def _ref_route(p, x, cfg, groups):
    """The reference's routing, step by step as ``repro.models.moe.moe_mlp``
    computes it: (eidx, ranks, keep)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    g, Tg, cap = TM.dispatch_shape(B * S, groups, cfg)
    xf = x.reshape(g, Tg, d)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xf, p["router"].astype(x.dtype))
                           .astype(jnp.float32), axis=-1)
    gate, eidx = jax.lax.top_k(probs, k)
    gate = gate / jnp.sum(gate, axis=-1, keepdims=True)
    e_flat = eidx.reshape(g, Tg * k)
    ranks = jax.vmap(lambda e: RM._ranks_within_expert(e, E))(e_flat)
    keep = (ranks < cap).astype(jnp.float32) * gate.reshape(g, Tg * k)
    return np.asarray(eidx), np.asarray(ranks), np.asarray(keep), cap


@pytest.mark.parametrize("shape", [(2, 64), (3, 7), (4, 1)], ids=["T=128", "T=21-groups-lowered",
                                                                   "S=1"])
@pytest.mark.parametrize("factor", [1.25, 8.0], ids=["cap1.25", "cap8"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_mlp_matches_the_reference(arch, factor, shape):
    rcfg, tcfg = _cfgs(arch, expert_capacity_factor=factor)
    p = jax.tree.map(lambda a: a[0], _ref_params(arch)["layers"]["b0"]["mlp"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = np.random.default_rng(3).normal(size=(*shape, rcfg.d_model)).astype(np.float32)
    if shape == (2, 64):  # every token leans toward expert 0, which overflows at 1.25
        r0 = np.asarray(p["router"])[:, 0]
        x = (x + 2.0 * r0 / np.linalg.norm(r0)).astype(np.float32)
    groups = rcfg.moe_groups
    eidx, ranks, keep, cap = _ref_route(p, jnp.asarray(x), rcfg, groups)
    g, Tg, _ = TM.dispatch_shape(shape[0] * shape[1], groups, tcfg)
    _, teidx, tranks, tkeep = TM.route(tp["router"], torch.from_numpy(x).reshape(g, Tg, -1), tcfg, cap)
    np.testing.assert_array_equal(teidx.numpy(), eidx)
    np.testing.assert_array_equal(tranks.numpy(), ranks)
    np.testing.assert_array_equal(tkeep.numpy() > 0, keep > 0)
    np.testing.assert_allclose(tkeep.numpy(), keep, rtol=1e-5, atol=0)
    dropped = int((ranks >= cap).sum())
    if shape == (2, 64):  # cap 8.0 is Tg = 64: nothing can drop
        assert (dropped > 0) == (factor == 1.25), dropped
    want, waux = RM.moe_mlp(p, jnp.asarray(x), rcfg, groups=groups)
    with TM.drop_log() as log:
        got, aux = TM.moe_mlp(tp, torch.from_numpy(x), tcfg, groups=groups)
    assert [(int(n), m) for n, m in log] == [(dropped, ranks.size)]
    assert got.shape == x.shape and aux.dtype == torch.float32 and aux.shape == ()
    assert _rel(got, want) <= 1e-5
    assert abs(float(aux) - float(waux)) <= 1e-6 * abs(float(waux))


def test_drop_log_records_only_inside_its_block():
    _, tcfg = _cfgs("grok_1_314b")
    p = {k: torch.from_numpy(np.array(v[0]))
         for k, v in _ref_params("grok_1_314b")["layers"]["b0"]["mlp"].items()}
    x = torch.randn(2, 4, tcfg.d_model)
    TM.moe_mlp(p, x, tcfg, groups=2)
    with TM.drop_log() as log:
        TM.moe_mlp(p, x, tcfg, groups=2)
        with TM.drop_log() as inner:
            TM.moe_mlp(p, x, tcfg, groups=2)
    assert len(log) == 1 and len(inner) == 1 and TM._DROPS is None


# --------------------------------------------------------------------------- the models

@pytest.mark.parametrize("arch", ["llama4_maverick_400b_a17b", "grok_1_314b", "smollm_135m"])
def test_param_specs_carry_the_experts_and_router(arch):
    _, tcfg = _cfgs(arch)
    specs = TT.param_specs(tcfg, dtype=torch.bfloat16)
    mlp = specs["layers"]["b0"]["mlp"]
    if tcfg.num_experts:
        E, d, f = tcfg.num_experts, tcfg.d_model, tcfg.d_ff
        n = tcfg.num_layers // len(tcfg.block_pattern)
        assert mlp["router"].shape == (n, d, E) and mlp["router"].dtype == torch.float32
        assert mlp["wi"].shape == mlp["wg"].shape == (n, E, d, f)
        assert mlp["wi"].logical == ("layers", "experts", "embed", "mlp")
        assert mlp["wo"].logical == ("layers", "experts", "mlp", "embed")
    else:
        assert set(mlp) == {"wi", "wg", "wo"}


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_and_aux_match_in_float32(arch):
    rcfg, tcfg, params, model = _model(arch)
    toks = _tokens(rcfg, 0, (2, 64))
    x, aux, _ = RT.forward(params, rcfg, {"tokens": jnp.asarray(toks)})
    tx, taux, _ = model.forward({"tokens": torch.from_numpy(toks)})
    assert _rel(model.unembed(tx), RT.unembed(params, rcfg, x)) < F32_TOL
    assert taux.dtype == torch.float32 and float(taux) > 0
    assert abs(float(taux) - float(aux)) <= 1e-5 * abs(float(aux))


def _cache_diff(got, want, cfg):
    """The caches agree: each K/V entry within one bf16 ulp of its value or
    within 1e-5 of its leaf's max|.|, at most FLIP_FRACTION of the written
    entries off at all; ``kpos`` exact."""
    g, w = convert.lm_cache_to_numpy(got, cfg), jax.tree.map(np.asarray, want)
    assert set(g["layers"]) == set(w["layers"]) and set(g["tail"]) == set(w["tail"])
    flips = n = 0
    for part in ("layers", "tail"):
        for blk, leaves in g[part].items():
            assert set(leaves) == set(w[part][blk]), blk
            for k, a in leaves.items():
                b = _np(w[part][blk][k])
                assert a.shape == b.shape, (blk, k)
                if k == "kpos":
                    assert a.dtype == np.int32
                    np.testing.assert_array_equal(a, b, err_msg=blk)
                    continue
                d = np.abs(a.astype(np.float64) - b)
                assert np.all(d <= np.maximum(2.0 ** -7 * np.abs(b), 1e-5 * np.abs(b).max())), (blk, k)
                flips += int((d > 0).sum())
                n += int((b != 0).sum())
    assert flips <= FLIP_FRACTION * n, (flips, n)


def _carry_cache(ref_cache, cfg):
    """The reference's cache tree -> the port's per-layer list."""
    pat = len(cfg.block_pattern)
    n_groups = cfg.num_layers // pat

    def leaf(v, *i):
        return convert._param_tensor(np.asarray(v)[i] if i else np.asarray(v), torch.device("cpu"))

    out = [{k: leaf(v, i) for k, v in ref_cache["layers"][f"b{j}"].items()}
           for i in range(n_groups) for j in range(pat)]
    return out + [{k: leaf(v) for k, v in ref_cache["tail"][f"t{i}"].items()}
                  for i in range(len(ref_cache["tail"]))]


def _kpos_of(cache, cfg, pos_next):
    """The ``kpos`` a ring of W slots holds once positions 0 .. pos_next-1
    are written: slot s the latest position p < pos_next with p % W == s."""
    out = []
    for c, lt in zip(cache, cfg.layer_types()):
        if lt != "attn_chunked":
            continue
        W = c["kpos"].shape[0]
        want = np.full(W, -1, np.int32)
        for p in range(max(0, pos_next - W), pos_next):
            want[p % W] = p
        out.append((c["kpos"].numpy(), want))
    return out


@pytest.mark.parametrize("prompt,steps", [(20, 16), (64, 36)], ids=["short-crosses-32",
                                                                     "long-crosses-96"])
@pytest.mark.parametrize("arch,family", [(MOE[0], None), (MOE[0], "hybrid"), (MOE[1], None)],
                         ids=["llama4-chunk", "llama4-hybrid-window", "grok"])
def test_prefill_and_decode_match_in_float32(arch, family, prompt, steps):
    """Prefill, then teacher-forced decode steps across a chunk boundary,
    each against the reference's compiled functions.  Each step starts from
    the reference's cache carried across, so that a cache entry rounded the
    other way in one step does not carry into the next (it moves these
    random-weight logits by up to 2e-4): logits and the cache each step
    writes are held to the reference's.  The port's own chain of steps then
    holds its ring's ``kpos`` to the positions.  The hybrid case runs
    llama4's smoke config with ``family="hybrid"``: its ``attn_chunked``
    layers attend a sliding window (``local_window``)."""
    kw = {"family": family} if family else {}
    rcfg, tcfg, params, model = _model(arch, **kw)
    B = 2
    toks, nxt = _tokens(rcfg, 0, (B, prompt)), _tokens(rcfg, 1, (B, steps))
    L = prompt + steps + 2
    rl, rc = RSS.make_prefill(rcfg, L)(params, {"tokens": jnp.asarray(toks)})
    tl, tc = SS.make_prefill(tcfg, L)(model, {"tokens": torch.from_numpy(toks)})
    assert _rel(tl, rl) < F32_TOL
    _cache_diff(tc, rc, tcfg)
    for got, want in _kpos_of(tc, tcfg, prompt):
        np.testing.assert_array_equal(got, want)
    rdec, tdec = jax.jit(RSS.make_decode(rcfg)), SS.make_decode(tcfg)
    for t in range(steps):
        tok, pos = nxt[:, t], prompt + t
        cl, cc = tdec(model, _carry_cache(rc, tcfg), torch.from_numpy(tok), pos)
        rl, rc = rdec(params, rc, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        assert _rel(cl, rl) < F32_TOL, t
        _cache_diff(cc, rc, tcfg)
        tl, tc = tdec(model, tc, torch.from_numpy(tok), pos)
        assert bool(torch.isfinite(tl).all())
    for got, want in _kpos_of(tc, tcfg, prompt + steps):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", MOE)
def test_greedy_generate_tokens_equal_in_float32(arch):
    rcfg, tcfg, params, model = _model(arch)
    toks = _tokens(rcfg, 2, (2, 24))
    want = np.asarray(RSS.greedy_generate(rcfg, params, {"tokens": jnp.asarray(toks)},
                                          steps=14, cache_len=40))
    got = SS.greedy_generate(tcfg, model, {"tokens": torch.from_numpy(toks)}, steps=14,
                             cache_len=40)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S", [12, 64])
@pytest.mark.parametrize("arch", MOE)
def test_incremental_decode_matches_forward_without_drops(arch, S):
    """``tests/test_archs.py::test_incremental_decode_matches_forward`` with
    a capacity that drops nothing (8.0): token-by-token decode from an empty
    float32 cache reproduces the full forward, across a chunk at S=64."""
    _, tcfg = _cfgs(arch, expert_capacity_factor=8.0)
    model = TT.init_model(tcfg, seed=2, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, 4, (2, S)))
    x, _, _ = model.forward({"tokens": toks})
    ref = model.unembed(x[:, -1]).numpy()
    cache = [{k: v.float() if v.is_floating_point() else v for k, v in c.items()}
             for c in model.init_cache(2, S)]
    for t in range(S):
        logits, cache = model.decode_step(toks[:, t], cache, t)
    rel = np.max(np.abs(logits.numpy() - ref)) / np.max(np.abs(ref))
    assert rel < INCR_TOL, rel


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_consistency(arch):
    """``tests/test_archs.py::test_prefill_decode_consistency`` on the port,
    at its capacity factor of 8.0."""
    _, tcfg = _cfgs(arch, expert_capacity_factor=8.0)
    model = TT.init_model(tcfg, seed=1, dtype=torch.float32, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, 3, (2, 16)))}
    x, _, _ = model.forward(batch)
    ref = model.unembed(x[:, -1]).numpy()
    logits, cache = SS.make_prefill(tcfg, cache_len=20)(model, batch)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0.06, atol=0.05)
    l2, _ = SS.make_decode(tcfg)(model, cache, torch.argmax(logits, -1).to(torch.int32), 16)
    assert torch.isfinite(l2).all()


@pytest.mark.parametrize("arch", MOE)
def test_bf16_serving_holds_to_its_own_forward(arch):
    """bf16 weights, where a route can flip between devices: the port's
    prefill and incremental decode held to its own forward within the
    dense family's bf16 tolerances (``test_torch_lm.py``'s 0.06/0.05 for
    the prefill, ``chip_smoke.py``'s 0.25 of max|logit| for incremental
    decode), at a capacity that drops nothing."""
    _, tcfg = _cfgs(arch, expert_capacity_factor=8.0)
    model = TT.init_model(tcfg, seed=4, dtype=torch.bfloat16, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, 5, (2, 64)))  # two of llama4's 32-token chunks
    x, aux, _ = model.forward({"tokens": toks})
    ref = model.unembed(x[:, -1]).float().numpy()
    assert aux.dtype == torch.float32 and torch.isfinite(aux)
    logits, _ = SS.make_prefill(tcfg, cache_len=68)(model, {"tokens": toks})
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0.06, atol=0.05)
    cache = model.init_cache(2, 64)
    for t in range(64):
        logits, cache = model.decode_step(toks[:, t], cache, t)
    assert np.max(np.abs(logits.numpy() - ref)) / np.max(np.abs(ref)) < 0.25


@pytest.mark.parametrize("arch", MOE)
def test_per_example_loss_is_refused_for_moe(arch):
    from repro_torch import metrics

    _, tcfg = _cfgs(arch)
    model = TT.init_model(tcfg, seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="dispatch group"):
        model.example_nll(torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="dispatch group"):
        metrics.lm_loss_per_example(model, 8)


# --------------------------------------------------------------------------- training

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


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_over_three_steps(arch, micro):
    """Three Adafactor steps (the configs' optimizer), each from the
    reference's state after the one before, as in ``test_torch_train.py``."""
    rcfg, tcfg = _cfgs(arch, train_microbatches=micro)
    assert rcfg.optimizer == "adafactor"
    params = _ref_params(arch)
    ropt = RO.opt_init(params, rcfg.optimizer)
    rstep = jax.jit(RTS.make_train_step(rcfg, lr=LR))
    tstep = TS.make_train_step(tcfg, lr=LR)
    for i in range(3):
        model, topt = convert.lm_train_state_from_reference(
            jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, ropt), tcfg, device="cpu")
        toks = _tokens(rcfg, 10 + i, (4, 32))
        params, ropt, rm = rstep(params, ropt, {"tokens": jnp.asarray(toks)})
        model, topt, tm = tstep(model, topt, {"tokens": torch.from_numpy(toks)})
        for k in rm:
            tol = 1e-4 if k == "grad_norm" else 1e-5
            assert abs(float(tm[k]) - float(rm[k])) <= tol * abs(float(rm[k])), (i, k)
        _params_close(model, params, LR)


@pytest.mark.parametrize("arch", MOE)
def test_value_and_grad_matches_in_float32(arch):
    """The loss (cross-entropy plus AUX_LOSS_WEIGHT·aux) and every grad leaf,
    the router's and the experts' included, within 1e-4 of max|grad|."""
    rcfg, tcfg, params, _ = _model(arch)
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg,
                                             device="cpu").requires_grad_(True)
    toks = _tokens(rcfg, 0, (4, 32))
    (rl, rce), rg = jax.value_and_grad(RTS.loss_fn, has_aux=True)(
        params, rcfg, {"tokens": jnp.asarray(toks)})
    (tl, tce), tg = TS.value_and_grad(model, tcfg, {"tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(rl)) <= 1e-5 * abs(float(rl)) and float(tl) > float(tce)
    ref_leaves = jax.tree.flatten_with_path(rg)[0]
    for (path, r), g in zip(ref_leaves, tree_leaves(tg)):
        r, g = _np(r), _np(g)
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), jax.tree_util.keystr(path)
    assert np.abs(_np(tg["layers"]["b0"]["mlp"]["router"])).max() > 0


@pytest.mark.parametrize("arch", MOE)
def test_remat_policies_give_bitwise_equal_grads(arch):
    toks = torch.from_numpy(_tokens(rget(arch).smoke(), 2, (4, 32)))
    out = {}
    for policy in ("none", "full", "dots"):
        _, tcfg = _cfgs(arch, remat=policy)
        model = TT.init_model(tcfg, seed=3, dtype=torch.float32, device="cpu").requires_grad_(True)
        (loss, _), g = TS.value_and_grad(model, tcfg, {"tokens": toks})
        out[policy] = (loss, tree_leaves(g))
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[policy][1], out["none"][1])), policy


# --------------------------------------------------------------------------- entry points

@pytest.mark.parametrize("arch", MOE)
def test_serve_step_main_runs_on_the_cpu(arch, capsys):
    out = SS.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                   "--prompt-len", "8", "--gen", "4"])
    assert out.shape == (2, 4) and out.dtype == torch.int32
    assert f"arch={tget(arch).name} device=cpu generated [2, 4]" in capsys.readouterr().out


@pytest.mark.parametrize("arch", MOE)
def test_train_main_runs_and_resumes_on_the_cpu(arch, tmp_path, capsys):
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    model, opt = TRAIN.main(args + ["--steps", "2"])
    model, opt = TRAIN.main(args + ["--steps", "4", "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert int(opt.step) == 4
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(model.params))
