"""The port's LM serving path (``repro_torch.configs``, ``models``,
``serve_step``, ``data.tokens``) against the JAX reference on the CPU.

Inputs are made once with numpy (tokens) or the reference's own
``init_params`` (weights), and carried across: the port's parameters by
``convert.lm_params_from_reference``, its caches back by
``convert.lm_cache_to_numpy``.

Tolerances, each relative to the largest |logit| of the reference:
* float32 weights: 1e-4 for prefill and every decode step, against the
  reference's compiled functions; greedy tokens equal.
* bf16 weights: 2e-2, against the reference evaluated one primitive at a
  time (its layer functions in a Python loop). The compiled reference is
  not the yardstick in bf16: XLA fuses elementwise chains and keeps their
  intermediates in float32, so it differs from its own primitive-by-
  primitive evaluation by up to 2.4e-2 on these models (measured on the
  four smoke configs), while the port rounds where the primitives do.
* caches, float32 weights: a K/V value near a bf16 (or int8) rounding
  boundary can round to the neighbouring value in the other framework, so
  at most 0.1% of the cache entries may differ, each by one bf16 ulp (one
  int8 step); the int8 scales within 1e-5.  bf16 weights: within 2e-2 of
  max|cache|, as the logits (the K/V carry the activations' roundings).
* int8 caches: the decode steps start from the reference's prefill cache
  carried across (one flipped entry moves these random-weight logits by
  up to 6e-4), and the entries they write are counted as above.
* layers: float32 within 1e-5 of max|ref|; bf16 within one bf16 ulp of the
  value or of max|ref| (the reference's attention sums its key blocks in a
  compiled ``lax.scan``, which rounds the probabilities of each block
  against its running maximum).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as LP
from repro.configs import base as RB
from repro.configs import get_config as rget
from repro.data import tokens as RTOK
from repro.models import layers as RL
from repro.models import spec as RSPEC
from repro.models import transformer as RT
from repro.serving import serve_step as RSS
from repro_torch import convert
from repro_torch import serve_step as SS
from repro_torch.configs import base as TB
from repro_torch.configs import get_config as tget
from repro_torch.data import tokens as TTOK
from repro_torch.models import layers as TL
from repro_torch.models import spec as TSPEC
from repro_torch.models import transformer as TT

DENSE = ["smollm_135m", "deepseek_7b", "qwen3_32b", "nemotron_4_15b"]
MOE = ["llama4_maverick_400b_a17b", "grok_1_314b"]
OTHERS = ["whisper_base", "internvl2_1b", "recurrentgemma_9b", "xlstm_125m"]
B, S, STEPS = 2, 16, 6
F32_TOL, BF16_TOL = 1e-4, 2e-2
FLIP_FRACTION = 1e-3


def _np(a):
    """Reference or port array -> float64 numpy (bf16 exactly)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().float() if a.is_floating_point() else a.detach()
        return a.numpy().astype(np.float64)
    a = np.asarray(a)
    return a.astype(np.float32).astype(np.float64) if a.dtype.name == "bfloat16" else a.astype(np.float64)


def _rel(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / np.abs(w).max())


@functools.lru_cache(maxsize=None)
def _model(arch, dtype_name):
    cfg = rget(arch).smoke()
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    params = RSPEC.init_params(RT.param_specs(cfg, dtype=jdt), jax.random.key(1))
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                             tget(arch).smoke(), device="cpu")
    return cfg, params, model


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


# --------------------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", RB.ASSIGNED)
def test_configs_equal_the_reference_field_for_field(arch):
    mine, ref = tget(arch), rget(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.smoke()) == dataclasses.asdict(ref.smoke())
    for c, r in ((mine, ref), (mine.smoke(), ref.smoke())):
        assert (c.head_dim_, c.vocab_padded, c.layer_types(), c.supports_long_context) == (
            r.head_dim_, r.vocab_padded, r.layer_types(), r.supports_long_context)
    assert tget(arch.replace("_", "-")) is mine
    assert type(mine).__module__ == "repro_torch.configs.base"


def test_config_registry_and_padding():
    assert TB.ASSIGNED == RB.ASSIGNED and TB.list_archs() == RB.list_archs()
    assert tget("qwen3_32b").vocab_padded == 152_064  # 151,936 padded to %256
    assert tget("smollm_135m").vocab_padded == 49_152
    with pytest.raises(ModuleNotFoundError):
        tget("no_such_arch")


# --------------------------------------------------------------------------- tokens

@pytest.mark.parametrize("arch", ["smollm_135m", "internvl2_1b", "whisper_base"])
def test_token_batches_are_the_reference_tokens_bitwise(arch):
    cfg = tget(arch).smoke()
    ref = RTOK.token_batches(rget(arch).smoke(), 3, 10, start=5, seed=7)
    mine = TTOK.token_batches(cfg, 3, 10, start=5, seed=7, device="cpu")
    for _ in range(3):
        (rb, rc), (tb, tc) = next(ref), next(mine)
        assert rc == tc and set(rb) == set(tb)
        assert tb["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(rb["tokens"]))
        for k in set(rb) - {"tokens"}:
            assert tb[k].dtype == torch.float32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(rb[k]))
    wide, _ = next(TTOK.token_batches(cfg, 3, 10, start=5, seed=7, device="cpu",
                                      dtype=torch.int64))
    assert wide["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(wide["tokens"].numpy(),
                                  np.asarray(next(RTOK.token_batches(
                                      rget(arch).smoke(), 3, 10, start=5, seed=7))[0]["tokens"]))


# --------------------------------------------------------------------------- layers

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _pair(x, dt):
    return jnp.asarray(x, dt[0]), torch.from_numpy(np.asarray(x, np.float32)).to(dt[1])


def _layer_close(got, want, dt):
    g, w = _np(got), _np(want)
    if dt[1] == torch.float32:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    else:  # one bf16 ulp of the value, or of max|ref| for values near 0
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=2.0 ** -8 * np.abs(w).max())


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_norms_match(dt):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)) * 3 + 1
    g, b = rng.normal(size=64), rng.normal(size=64)
    (xj, xt), (gj, gt), (bj, bt) = _pair(x, dt), _pair(g, dt), _pair(b, dt)
    _layer_close(TL.rms_norm(xt, gt), RL.rms_norm(xj, gj), dt)
    _layer_close(TL.layer_norm(xt, gt, bt), RL.layer_norm(xj, gj, bj), dt)
    _layer_close(TL.apply_norm(xt, {"scale": gt, "bias": bt}, "ln"),
                 RL.apply_norm(xj, {"scale": gj, "bias": bj}, "ln"), dt)
    assert TL.rms_norm(xt, gt).dtype == dt[1]


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_rope_matches(dt):
    rng = np.random.default_rng(1)
    np.testing.assert_allclose(TL.rope_freqs(16, 1e6).numpy(),
                               np.asarray(RL.rope_freqs(16, 1e6)), rtol=1e-6)
    x4 = rng.normal(size=(2, 7, 3, 16))
    pos = np.arange(3, 10)
    _layer_close(TL.apply_rope(_pair(x4, dt)[1], torch.from_numpy(pos), 1e4),
                 RL.apply_rope(_pair(x4, dt)[0], jnp.asarray(pos), 1e4), dt)
    x3 = rng.normal(size=(2, 3, 16))
    _layer_close(TL.apply_rope(_pair(x3, dt)[1], 37, 1e6),
                 RL.apply_rope(_pair(x3, dt)[0], jnp.asarray(37, jnp.int32), 1e6), dt)


def test_softcap_matches():
    s = np.random.default_rng(2).normal(size=(4, 9)) * 80
    np.testing.assert_allclose(TL.softcap(torch.from_numpy(s).float(), 30.0).numpy(),
                               np.asarray(RL.softcap(jnp.asarray(s, jnp.float32), 30.0)),
                               rtol=1e-6, atol=1e-5)
    t = torch.ones(3)
    assert TL.softcap(t, None) is t


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("mode,window,cap", [
    ("causal", None, None), ("causal", None, 30.0), ("chunk", 16, None),
    ("window", 8, None), ("full", None, None), ("chunk", 64, None)],
    ids=["causal", "causal-softcap", "chunk", "window", "full", "chunk-covers-all"])
def test_flash_attention_matches(mode, window, cap, dt):
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 32, H, 16)) for H in (4, 2, 2))  # GQA: G=2
    (qj, qt), (kj, kt), (vj, vt) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    kw = dict(mode=mode, window=window, cap=cap, q_block=8, kv_block=8)
    _layer_close(TL.flash_attention(qt, kt, vt, **kw), RL.flash_attention(qj, kj, vj, **kw), dt)


@pytest.mark.parametrize("cache_dt", [jnp.float32, jnp.bfloat16], ids=["f32-cache", "bf16-cache"])
@pytest.mark.parametrize("cap", [None, 30.0], ids=["plain", "softcap"])
def test_decode_attention_matches_with_a_fully_masked_row(cap, cache_dt):
    """Row 1 of ``valid`` masks every slot: both frameworks average the
    values uniformly (NEG_INF is finite)."""
    rng = np.random.default_rng(4)
    q, kc, vc = rng.normal(size=(2, 4, 16)), rng.normal(size=(2, 12, 2, 16)), rng.normal(size=(2, 12, 2, 16))
    valid = np.ones((2, 12), bool)
    valid[0, 7:] = False
    valid[1, :] = False
    tcache = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[cache_dt]
    got = TL.decode_attention(torch.from_numpy(q).float(), torch.from_numpy(kc).to(tcache),
                              torch.from_numpy(vc).to(tcache), torch.from_numpy(valid), cap=cap)
    want = RL.decode_attention(jnp.asarray(q, jnp.float32), jnp.asarray(kc, cache_dt),
                               jnp.asarray(vc, cache_dt), jnp.asarray(valid), cap=cap)
    _layer_close(got, want, DTYPES[0])
    uniform = _np(torch.from_numpy(vc).to(tcache)).mean(axis=1)[1]  # [K, dh]
    np.testing.assert_allclose(_np(got)[1].reshape(2, 2, 16),
                               np.broadcast_to(uniform[:, None], (2, 2, 16)), rtol=1e-5, atol=1e-6)
    v1 = np.ones(12, bool)  # the [S] form of valid
    got1 = TL.decode_attention(torch.from_numpy(q).float(), torch.from_numpy(kc).float(),
                               torch.from_numpy(vc).float(), torch.from_numpy(v1))
    _layer_close(got1, RL.decode_attention(jnp.asarray(q, jnp.float32), jnp.asarray(kc, jnp.float32),
                                           jnp.asarray(vc, jnp.float32), jnp.asarray(v1)), DTYPES[0])


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["silu", "gelu", "relu2"])
def test_mlp_act_matches(kind, dt):
    x = np.random.default_rng(5).normal(size=20_000) * 4
    xj, xt = _pair(x, dt)
    fn = {"silu": jax.nn.silu, "gelu": jax.nn.gelu, "relu2": lambda a: jax.nn.relu(a) ** 2}[kind]
    got, want = TL.mlp_act(xt, kind), fn(xj)
    if dt[1] == torch.bfloat16:  # one primitive at a time: bitwise
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    if kind == "gelu":  # the tanh approximation, as jax.nn.gelu's default
        exact = torch.nn.functional.gelu(torch.from_numpy(x).float())
        assert (TL.mlp_act(torch.from_numpy(x).float(), kind) - exact).abs().max() > 1e-5


@pytest.mark.parametrize("arch", ["smollm_135m", "nemotron_4_15b"])  # gated silu, ungated relu2
def test_mlp_matches(arch):
    cfg, params, model = _model(arch, "float32")
    x = np.random.default_rng(6).normal(size=(2, 5, cfg.d_model))
    p = jax.tree.map(lambda a: a[0], params["layers"]["b0"])["mlp"]
    got = TL.mlp(model.layers[0]["mlp"], torch.from_numpy(x).float(), tget(arch).smoke())
    _layer_close(got, RL.mlp(p, jnp.asarray(x, jnp.float32), cfg), DTYPES[0])


# --------------------------------------------------------------------------- specs

@pytest.mark.parametrize("arch", DENSE + MOE + OTHERS)
def test_param_specs_are_the_reference_tree(arch):
    cfg = tget(arch).smoke()
    mine = TSPEC.spec_leaves(TT.param_specs(cfg, dtype=torch.float32))
    ref, _ = jax.tree.flatten_with_path(RT.param_specs(rget(arch).smoke(), dtype=jnp.float32),
                                        is_leaf=RSPEC.is_spec)
    assert [p for p, _ in mine] == ["/".join(k.key for k in path) for path, _ in ref]
    for (_, a), (_, b) in zip(mine, ref):
        assert (a.shape, a.logical, a.init, a.scale) == (b.shape, b.logical, b.init, b.scale)


def test_init_params_draw_order_and_fan_in():
    cfg = tget("nemotron_4_15b").smoke()  # LayerNorm (zeros, ones), untied head
    specs = TT.param_specs(cfg, dtype=torch.float32)
    got = TSPEC.init_params(specs, torch.Generator().manual_seed(3), "cpu")
    gen = torch.Generator().manual_seed(3)
    for path, s in TSPEC.spec_leaves(specs):
        leaf = functools.reduce(lambda t, k: t[k], path.split("/"), got)
        if s.init in ("zeros", "ones"):
            assert torch.equal(leaf, torch.full(s.shape, float(s.init == "ones")))
            continue
        std = s.scale if s.init == "embed" else s.scale / np.sqrt(s.shape[0])
        want = (torch.randn(s.shape, generator=gen) * std).to(s.dtype)
        assert torch.equal(leaf, want), path
    # stacked leaves: fan-in is the layer count, as in the reference
    assert got["layers"]["b0"]["wq"].std().item() == pytest.approx(1 / np.sqrt(cfg.num_layers), rel=0.05)


@pytest.mark.parametrize("arch,layers", [("smollm_135m", None), ("deepseek_7b", None),
                                         ("deepseek_7b", 4), ("qwen3_32b", 8),
                                         ("nemotron_4_15b", 8)])
def test_init_params_draws_every_dense_leaf_whole(arch, layers):
    """No leaf of a dense config at the depth ``chip_smoke.py`` draws it
    (smollm-135m and deepseek-7b uncut, deepseek-7b at 4 layers, qwen3-32b
    and nemotron-4-15b at 8) reaches SLICE_BYTES: each is still one
    ``randn`` of its full shape, so the sliced draw leaves those weights
    bitwise as they were."""
    cfg = tget(arch) if layers is None else dataclasses.replace(tget(arch), num_layers=layers)
    sizes = [4 * int(np.prod(s.shape)) for _, s in TSPEC.spec_leaves(TT.param_specs(cfg))]
    assert max(sizes) <= TSPEC.SLICE_BYTES
    if arch == "deepseek_7b" and layers is None:
        assert max(sizes) == 4 * 30 * 4096 * 11008  # its stacked wi, 5.4 GB


def _draw(shape, std, limit, gen):
    if 4 * int(np.prod(shape)) <= limit:
        return torch.randn(shape, generator=gen) * std
    return torch.stack([_draw(shape[1:], std, limit, gen) for _ in range(shape[0])])


@pytest.mark.parametrize("arch", MOE)
def test_init_params_slices_a_leaf_past_the_threshold(arch, monkeypatch):
    """A leaf whose float32 draw exceeds SLICE_BYTES draws one ``randn`` a
    slice of its leading axis, in order, at the whole leaf's std (the fan-in
    rule unchanged), a slice still past it sliced again; a leaf under it
    draws whole.  The threshold is lowered to one expert's [d, f] so that
    the smoke config's expert leaves (and its embedding) cross it; at the
    default every leaf draws whole, as before."""
    cfg = tget(arch).smoke()
    specs = TT.param_specs(cfg, dtype=torch.float32)

    def expected(limit):
        gen = torch.Generator().manual_seed(5)
        out = {}
        for path, s in TSPEC.spec_leaves(specs):
            if s.init in ("zeros", "ones"):
                continue
            std = s.scale if s.init == "embed" else s.scale / np.sqrt(s.shape[0])
            out[path] = _draw(s.shape, std, limit, gen)
        return out

    def leaf(tree, path):
        return functools.reduce(lambda t, k: t[k], path.split("/"), tree)

    limit = 4 * cfg.d_model * cfg.d_ff
    for lim in (limit, TSPEC.SLICE_BYTES):
        monkeypatch.setattr(TSPEC, "SLICE_BYTES", lim)
        got = TSPEC.init_params(specs, torch.Generator().manual_seed(5), "cpu")
        for path, want in expected(lim).items():
            assert torch.equal(leaf(got, path), want), (lim, path)
    experts = [p for p, s in TSPEC.spec_leaves(specs) if "experts" in s.logical]
    assert len(experts) == 3 * len(cfg.block_pattern) and all(
        4 * int(np.prod(leaf(specs, p).shape)) > limit for p in experts)
    assert 4 * int(np.prod(specs["layers"]["b0"]["wq"].shape)) <= limit  # drawn whole


# --------------------------------------------------------------------------- the dense configs

def _carry_cache(ref_cache, cfg):
    """The reference's stacked cache tree -> the port's per-layer list."""
    leaves = ref_cache["layers"]["b0"]
    return [{k: convert._param_tensor(np.asarray(v)[i], torch.device("cpu"))
             for k, v in leaves.items()} for i in range(cfg.num_layers)]


def _cache_diff(got, want, cfg, tol=None):
    """Assert the caches agree: up to rare one-step flips, or with ``tol``
    (bf16 weights) within ``tol`` of max|cache| leaf by leaf."""
    g, w = convert.lm_cache_to_numpy(got, cfg), jax.tree.map(_np, want)
    assert g["tail"] == {} and w["tail"] == {} and set(g["layers"]) == set(w["layers"]) == {"b0"}
    flips = n = 0
    for k, a in g["layers"]["b0"].items():
        b = w["layers"]["b0"][k]
        assert a.shape == b.shape, k
        if tol is not None:
            assert np.abs(a - b).max() <= tol * np.abs(b).max(), k
        elif k in ("ks", "vs"):
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)
        else:
            d = np.abs(a.astype(np.float64) - b)
            step = 1.0 if cfg.kv_cache_dtype == "int8" else 2.0 ** -7 * np.abs(b)  # int8 step / bf16 ulp
            assert np.all(d <= step), k
            flips += int((d > 0).sum())
            n += a.size
    assert flips <= FLIP_FRACTION * n, (flips, n)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_and_decode_match_in_float32(arch):
    cfg, params, model = _model(arch, "float32")
    tcfg = tget(arch).smoke()
    toks, nxt = _tokens(cfg, 0, (B, S)), _tokens(cfg, 1, (B, STEPS))
    rl, rc = RSS.make_prefill(cfg, S + STEPS + 2)(params, {"tokens": jnp.asarray(toks)})
    tl, tc = SS.make_prefill(tcfg, S + STEPS + 2)(model, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab_padded)
    assert _rel(tl, rl) < F32_TOL
    # float32 weights, a bf16 (or int8) cache: the prefill attended over
    # float32 K/V, the decode reads them rounded
    assert tc[0]["k"].dtype == (torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16)
    _cache_diff(tc, rc, tcfg)
    if cfg.kv_cache_dtype == "int8":
        tc = _carry_cache(rc, tcfg)
    for t in range(STEPS):  # teacher-forced on the reference's tokens
        rl, rc = RSS.make_decode(cfg)(params, rc, jnp.asarray(nxt[:, t]), jnp.asarray(S + t, jnp.int32))
        tl, tc = SS.make_decode(tcfg)(model, tc, torch.from_numpy(nxt[:, t]), S + t)
        assert _rel(tl, rl) < F32_TOL, t
    _cache_diff(tc, rc, tcfg)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generate_tokens_equal_in_float32(arch):
    cfg, params, model = _model(arch, "float32")
    toks = _tokens(cfg, 2, (B, S))
    want = np.asarray(RSS.greedy_generate(cfg, params, {"tokens": jnp.asarray(toks)},
                                          steps=8, cache_len=S + 9))
    got = SS.greedy_generate(tget(arch).smoke(), model, {"tokens": torch.from_numpy(toks)},
                             steps=8, cache_len=S + 9)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _eager_prefill(params, cfg, toks, cache_len):
    """The reference one primitive at a time: its layer functions in a
    Python loop, each jax primitive dispatched on its own."""
    x = jnp.take(params["embed"], toks, axis=0)
    caches = []
    for i in range(cfg.num_layers):
        p = jax.tree.map(lambda a: a[i], params["layers"]["b0"])
        x, c, _ = RT._attn_train(p, x, cfg, "attn", cache_len=cache_len)
        caches.append(c)
    x = RL.apply_norm(x, params["ln_f"], cfg.norm)
    return RT.unembed(params, cfg, x[:, -1]).astype(jnp.float32), caches


def _eager_decode(params, cfg, tok, caches, pos):
    x1 = jnp.take(params["embed"], tok, axis=0)
    out = []
    for i in range(cfg.num_layers):
        p = jax.tree.map(lambda a: a[i], params["layers"]["b0"])
        x1, c = RT._attn_decode(p, x1, caches[i], jnp.asarray(pos, jnp.int32), cfg, "attn")
        out.append(c)
    x1 = RL.apply_norm(x1, params["ln_f"], cfg.norm)
    return RT.unembed(params, cfg, x1).astype(jnp.float32), out


@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_and_decode_match_in_bf16(arch):
    cfg, params, model = _model(arch, "bfloat16")
    tcfg = tget(arch).smoke()
    toks, nxt = _tokens(cfg, 0, (B, S)), _tokens(cfg, 1, (B, STEPS))
    rl, rc = _eager_prefill(params, cfg, jnp.asarray(toks), S + STEPS + 2)
    tl, tc = SS.make_prefill(tcfg, S + STEPS + 2)(model, {"tokens": torch.from_numpy(toks)})
    assert _rel(tl, rl) < BF16_TOL
    for t in range(STEPS):
        rl, rc = _eager_decode(params, cfg, jnp.asarray(nxt[:, t]), rc, S + t)
        tl, tc = SS.make_decode(tcfg)(model, tc, torch.from_numpy(nxt[:, t]), S + t)
        assert _rel(tl, rl) < BF16_TOL, t
    stacked = {"layers": {"b0": {k: np.stack([np.asarray(c[k]) for c in rc]) for k in rc[0]}},
               "tail": {}}
    _cache_diff(tc, stacked, tcfg, tol=BF16_TOL)


# --------------------------------------------------------------------------- the reference's own tests

@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    """``tests/test_archs.py::test_prefill_decode_consistency`` on the port."""
    cfg = tget(arch).smoke()
    model = TT.init_model(cfg, seed=1, dtype=torch.float32, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 3, (B, S)))}
    x, _, _ = model.forward(batch)
    ref = model.unembed(x[:, -1]).numpy()
    logits, cache = SS.make_prefill(cfg, cache_len=S + 4)(model, batch)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0.06, atol=0.05)
    l2, cache = SS.make_decode(cfg)(model, cache, torch.argmax(logits, -1).to(torch.int32), x.shape[1])
    assert torch.isfinite(l2).all()


@pytest.mark.parametrize("arch", DENSE)
def test_incremental_decode_matches_forward(arch):
    """``tests/test_archs.py::test_incremental_decode_matches_forward`` on
    the port: token-by-token decode from an empty float32 cache reproduces
    the full forward (bf16 KV, int8 included, swapped for the float32 cache
    as the reference's test does)."""
    cfg = tget(arch).smoke()
    if cfg.kv_cache_dtype != "bf16":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="bf16")
    model = TT.init_model(cfg, seed=2, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 4, (B, 12)))
    x, _, _ = model.forward({"tokens": toks})
    ref = model.unembed(x[:, -1]).numpy()
    cache = [{k: v.float() for k, v in c.items()} for c in model.init_cache(B, 12)]
    for t in range(12):
        logits, cache = model.decode_step(toks[:, t], cache, t)
    assert cache[0]["k"].dtype == torch.float32
    rel = np.max(np.abs(logits.numpy() - ref)) / (np.max(np.abs(ref)) + 1e-9)
    assert rel < 2e-3, rel


# --------------------------------------------------------------------------- the other families' trees

@pytest.mark.parametrize("arch", OTHERS)
def test_full_size_param_specs_are_the_reference_tree_with_its_dtypes(arch):
    """The four families the later slices ported, at their published sizes:
    paths, shapes, logical axes, inits, scales and dtypes (bf16 parameters,
    float32 ``lam``/``b_if``/sLSTM biases), specs only — nothing is drawn."""
    LP.check_param_specs(arch, full=True)


def test_learned_positions_build_pos_embed_as_the_reference():
    """A smollm variant with ``pos="learned"``: the tree gains ``pos_embed``
    [MAX_LEARNED_POS, d] (init "embed", std 0.02), and the forward adds its
    rows, within the float32 tolerance of the reference's logits."""
    rcfg = dataclasses.replace(rget("smollm_135m").smoke(), pos="learned")
    tcfg = dataclasses.replace(tget("smollm_135m").smoke(), pos="learned")
    spec = TT.param_specs(tcfg, dtype=torch.float32)["pos_embed"]
    rspec = RT.param_specs(rcfg, dtype=jnp.float32)["pos_embed"]
    assert (spec.shape, spec.logical, spec.init, spec.scale) == (
        rspec.shape, rspec.logical, rspec.init, rspec.scale) == (
        (TT.MAX_LEARNED_POS, 64), (None, "embed"), "embed", 0.02)
    params = RSPEC.init_params(RT.param_specs(rcfg, dtype=jnp.float32), jax.random.key(1))
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    toks = _tokens(rcfg, 0, (B, S))
    x, _, _ = RT.forward(params, rcfg, {"tokens": jnp.asarray(toks)})
    tx, _, _ = model.forward({"tokens": torch.from_numpy(toks)})
    assert _rel(model.unembed(tx), RT.unembed(params, rcfg, x)) < F32_TOL
    rl, rc = RSS.make_decode(rcfg)(params, RT.init_cache(rcfg, B, 8), jnp.asarray(toks[:, 0]),
                                   jnp.asarray(5, jnp.int32))
    tl, _ = SS.make_decode(tcfg)(model, model.init_cache(B, 8), torch.from_numpy(toks[:, 0]), 5)
    assert _rel(tl, rl) < F32_TOL


def test_no_cpu_fallback():
    """The models and ``serve_step.main`` default to the card and raise
    without one, as ``_device.resolve_device`` does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = tget("smollm_135m").smoke()
    with pytest.raises(RuntimeError, match="cuda"):
        TT.init_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        SS.main(["--arch", "smollm_135m", "--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        next(TTOK.token_batches(cfg, 1, 4))


def test_serve_step_main_runs_on_the_cpu_when_asked(capsys):
    out = SS.main(["--arch", "qwen3_32b", "--smoke", "--device", "cpu", "--batch", "2",
                   "--prompt-len", "8", "--gen", "4"])
    assert out.shape == (2, 4) and out.dtype == torch.int32
    assert "arch=qwen3-32b device=cpu generated [2, 4]" in capsys.readouterr().out
