"""Parity checks of a whole LM family of the port against the JAX reference
on the CPU, shared by ``test_torch_recurrent.py`` and
``test_torch_encdec.py`` (this module holds no tests).

Weights are the reference's own ``init_params`` at ``smoke()`` size in
float32, carried across by ``convert.lm_params_from_reference``; tokens (and
the stubs' ``frames``/``patches``) come from the reference's
``token_batches`` (numpy draws from a seed), handed to both packages.

Tolerances (the dense and MoE families', ``test_torch_lm.py`` and
``test_torch_moe.py``):
* logits within ``F32_TOL`` = 1e-4 of max|logit|; greedy tokens equal;
  incremental decode within ``INCR_TOL`` = 2e-3 of the forward (the
  reference's own ``test_incremental_decode_matches_forward``).
* caches: ``kpos`` exact; a bf16 K/V entry (``k``, ``v``, ``xk``, ``xv``)
  within one bf16 ulp of its value or 1e-5 of its leaf's max|.|, at most
  ``FLIP_FRACTION`` = 0.5% of the written entries off at all (a float32
  value within its rounding error of a bf16 boundary rounds either way); a
  float32 recurrent state within ``F32_TOL`` of its leaf's max|.|.
* training: ``test_torch_train.py``'s tolerances (the loss within 1e-5
  relative, each grad leaf within 1e-4 of max|ref grad|; metrics 1e-5, the
  grad norm 1e-4; parameters within 1e-5 of max|param| plus 1% of an lr,
  except 0.1% of a leaf's entries, which may be up to 2·lr off).
* ``FLOAT32_COARSE``: the smoke configs whose random weights float32
  itself cannot resolve to these tolerances, in either framework.  xlstm:
  with the reference's fan-in rule its stacked weights (fan-in 1) have std
  1 (q/k/v) and 0.5 (the sLSTM's gates), and its exponential gates amplify
  rounding; both frameworks' float32 logits lie about 3e-4 of max|logit|
  from float64, a grad leaf up to 1e-2, and the sLSTM's input-gate bias
  ``bi`` has an exact gradient of 0 (a constant shift of every step's log
  input gate cancels in c/n), so its float32 grads are rounding alone.
  whisper: the reference's own float32 grads lie up to 5.2e-4 of a leaf's
  max|grad| from float64 (``pos_embed``; the port's 6.5e-4).  There each
  comparison runs besides in float64 on both sides: the reference's under
  :func:`ref_float64` (``x64``, with the ``float32`` its modules name for
  states, accumulators and casts read as float64) and the port's with its
  weights and batch in float64.  The port's float64 is held within
  ``F64_TOL`` = 1e-6 of the reference's float64 (of max|.|; measured
  7e-13 on xlstm's logits, 1e-12 on whisper's grads), and the port's
  float32 error against the reference's float64 within max(tol,
  ``FLOOR_FACTOR`` = 8 × the reference's own float32 error against it):
  the math is held in float64, a hundred times tighter than the float32
  tolerances, and the port's float32 no coarser than the reference's.
  recurrentgemma and internvl are held at the tolerances above as stated.
* bf16 serving against the port's own forward: the prefill within
  ``test_torch_lm.py``'s 0.06/0.05, incremental decode within 0.25 of
  max|logit| (``chip_smoke.py``'s ``LM_BF16_INCR_TOL``).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as rget
from repro.data import tokens as RTOK
from repro.models import layers as RL
from repro.models import mlstm_chunked as RMC
from repro.models import recurrent as RR
from repro.models import spec as RSPEC
from repro.models import transformer as RT
from repro.serving import serve_step as RSS
from repro.training import optimizer as RO
from repro.training import train_step as RTS
from repro_torch import convert
from repro_torch import serve_step as SS
from repro_torch import train as TRAIN
from repro_torch.configs import get_config as tget
from repro_torch.models import spec as TSPEC
from repro_torch.models.layers import proj
from repro_torch.models import transformer as TT
from repro_torch.training import train_step as TS
from repro_torch.uda import tree_leaves, tree_map

F32_TOL, INCR_TOL = 1e-4, 2e-3
F64_TOL = 1e-6
FLOOR_FACTOR = 8.0
FLOAT32_COARSE = frozenset({"xlstm_125m", "whisper_base"})
FLIP_FRACTION = 5e-3
LR = 1e-4
KV_LEAVES = ("k", "v", "xk", "xv")


def cfgs(arch, **kw):
    return (dataclasses.replace(rget(arch).smoke(), **kw),
            dataclasses.replace(tget(arch).smoke(), **kw))


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return RSPEC.init_params(RT.param_specs(rget(arch).smoke(), dtype=jnp.float32),
                             jax.random.key(1))


def model(arch, **kw):
    rcfg, tcfg = cfgs(arch, **kw)
    params = ref_params(arch)
    m = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return rcfg, tcfg, params, m


def batch(cfg, B, S, seed):
    """(the reference's batch, the port's): ``token_batches``' tokens and,
    for the stubs, ``frames`` or ``patches``."""
    rb, _ = next(RTOK.token_batches(cfg, B, S, seed=seed))
    return rb, {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}


def f64(x):
    """A port model, a batch or a cache in float64 (bf16 cache leaves kept:
    the decode reads them as stored)."""
    if isinstance(x, TT.Transformer):
        return TT.Transformer(x.cfg, tree_map(lambda t: t.detach().double(), x.params))
    return tree_map(lambda t: t.double() if t.dtype == torch.float32 else t, x)


class _WideJnp:
    """``jax.numpy`` with ``float32`` read as ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


_REF_MODULES = (RL, RMC, RR, RT, RO, RTS, RSS)


@contextlib.contextmanager
def ref_float64():
    """The reference evaluated in float64 throughout: ``x64`` on, and the
    ``float32`` its modules name for states, accumulators and casts read
    as float64 while the block runs (functions traced inside it only)."""
    with jax.enable_x64(True):
        saved = [m.jnp for m in _REF_MODULES]
        for m in _REF_MODULES:
            m.jnp = _WideJnp()
        try:
            yield
        finally:
            for m, j in zip(_REF_MODULES, saved):
                m.jnp = j


def r64(tree):
    """The reference's float32 leaves as float64 arrays (bf16 cache leaves
    and integers kept); call under :func:`ref_float64`."""
    def leaf(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)
    return jax.tree.map(leaf, tree)


def close(got, want, tol, what="", exact=None):
    """The port's float32 ``got`` within ``tol`` of max|want| of the
    reference's ``want``; for a FLOAT32_COARSE config ``exact`` is (the
    port's float64, the reference's float64) instead: the two within
    F64_TOL, and ``got``'s error against the reference's float64 within
    max(tol, FLOOR_FACTOR × ``want``'s)."""
    if exact is None:
        r = rel(got, want)
        assert r <= tol, (what, r, tol)
        return
    port64, ref64 = exact
    d64, e_port, e_ref = rel(port64, ref64), rel(got, ref64), rel(want, ref64)
    assert d64 <= F64_TOL, (what, d64)
    assert e_port <= max(tol, FLOOR_FACTOR * e_ref), (what, e_port, e_ref)


def prefix(cfg) -> int:
    return cfg.vis_tokens if cfg.frontend == "vision_stub" else 0


def np64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().double() if a.is_floating_point() else a.detach()
        return a.numpy().astype(np.float64)
    a = np.asarray(a)
    return a.astype(np.float32).astype(np.float64) if a.dtype.name == "bfloat16" else a.astype(np.float64)


def rel(got, want):
    g, w = np64(got), np64(want)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / np.abs(w).max())


def _block_types(cfg):
    pat = cfg.block_pattern
    n_groups = cfg.num_layers // len(pat)
    tail = cfg.layer_types()[n_groups * len(pat):]
    return {**{f"b{j}": lt for j, lt in enumerate(pat)}, **{f"t{i}": lt for i, lt in enumerate(tail)}}


def cache_diff(got, want, cfg, exact=None):
    """The port's cache list against the reference's cache tree, leaf by
    leaf, with the module's tolerances (``exact``: (the port's float64
    cache list, the reference's float64 cache tree) for a FLOAT32_COARSE
    config's float32 states)."""
    g, w = convert.lm_cache_to_numpy(got, cfg), jax.tree.map(np.asarray, want)
    if exact is not None:
        e = (convert.lm_cache_to_numpy(exact[0], cfg), jax.tree.map(np.asarray, exact[1]))
    assert set(g["layers"]) == set(w["layers"]) and set(g["tail"]) == set(w["tail"])
    types = _block_types(cfg)
    flips = n = 0
    for part in ("layers", "tail"):
        for blk, leaves in g[part].items():
            assert set(leaves) == set(w[part][blk]), blk
            for k, a in leaves.items():
                b = np64(w[part][blk][k])
                assert a.shape == b.shape, (blk, k)
                if k == "kpos":
                    assert a.dtype == np.int32
                    np.testing.assert_array_equal(a, b, err_msg=blk)
                    continue
                d = np.abs(a.astype(np.float64) - b)
                if k in KV_LEAVES and types[blk] in TT._ATTN:
                    assert np.all(d <= np.maximum(2.0 ** -7 * np.abs(b), 1e-5 * np.abs(b).max())), (blk, k)
                    flips += int((d > 0).sum())
                    n += int((b != 0).sum())
                else:
                    assert a.dtype == np.float32, (blk, k)
                    close(a, b, F32_TOL, what=(blk, k), exact=None if exact is None else
                          (e[0][part][blk][k], e[1][part][blk][k]))
    assert flips <= FLIP_FRACTION * max(n, 1), (flips, n)


def carry_cache(ref_cache, cfg):
    """The reference's cache tree -> the port's per-layer list."""
    pat = len(cfg.block_pattern)
    n_groups = cfg.num_layers // pat

    def leaf(v, *i):
        return convert._param_tensor(np.asarray(v)[i] if i else np.asarray(v), torch.device("cpu"))

    out = [{k: leaf(v, i) for k, v in ref_cache["layers"][f"b{j}"].items()}
           for i in range(n_groups) for j in range(pat)]
    return out + [{k: leaf(v) for k, v in ref_cache["tail"][f"t{i}"].items()}
                  for i in range(len(ref_cache["tail"]))]


# --------------------------------------------------------------------------- the checks

def check_param_specs(arch, full: bool):
    """The spec tree's paths, shapes, logical axes, inits, scales and
    dtypes equal the reference's (bf16 parameters, so the float32 leaves
    show); specs only, nothing allocated."""
    rcfg, tcfg = (rget(arch), tget(arch)) if full else cfgs(arch)
    mine = TSPEC.spec_leaves(TT.param_specs(tcfg, dtype=torch.bfloat16))
    ref, _ = jax.tree.flatten_with_path(RT.param_specs(rcfg, dtype=jnp.bfloat16),
                                        is_leaf=RSPEC.is_spec)
    assert [p for p, _ in mine] == ["/".join(k.key for k in path) for path, _ in ref]
    for (path, a), (_, b) in zip(mine, ref):
        assert (a.shape, a.logical, a.init, a.scale) == (b.shape, b.logical, b.init, b.scale), path
        assert str(a.dtype).removeprefix("torch.") == jnp.dtype(b.dtype).name, path
    return mine


def check_forward(arch, **kw):
    rcfg, tcfg, params, m = model(arch, **kw)
    rb, tb = batch(rcfg, 2, 20, seed=0)
    x, _, _ = RT.forward(params, rcfg, rb)
    tx, taux, _ = m.forward(tb)
    assert tx.shape == x.shape and float(taux) == 0.0
    exact = None
    if arch in FLOAT32_COARSE:
        m64 = f64(m)
        with ref_float64():
            p64, b64 = r64(params), r64(rb)
            want64 = RT.unembed(p64, rcfg, RT.forward(p64, rcfg, b64)[0])
        exact = (m64.unembed(m64.forward(f64(tb))[0]), want64)
    close(m.unembed(tx), RT.unembed(params, rcfg, x), F32_TOL, exact=exact)


def check_prefill_and_decode(arch, prompt=20, steps=8, **kw):
    """Prefill, then teacher-forced decode steps, each against the
    reference's compiled functions; each step starts from the reference's
    cache carried across, so that a cache entry rounded the other way in
    one step does not carry into the next: logits and the cache each step
    writes are held to the reference's.  The port's own chain of steps runs
    beside and stays finite."""
    rcfg, tcfg, params, m = model(arch, **kw)
    coarse = arch in FLOAT32_COARSE
    B = 2
    rb, tb = batch(rcfg, B, prompt, seed=0)
    nxt = np.random.default_rng(1).integers(0, rcfg.vocab_size, (B, steps)).astype(np.int32)
    P = prefix(rcfg)
    L = P + prompt + steps + 2
    rl, rc = RSS.make_prefill(rcfg, L)(params, rb)
    tl, tc = SS.make_prefill(tcfg, L)(m, tb)
    assert tl.dtype == torch.float32 and tl.shape == (B, tcfg.vocab_padded)
    exact = None
    if coarse:
        m64 = f64(m)
        with ref_float64():
            p64 = r64(params)
            rdec64 = jax.jit(RSS.make_decode(rcfg))
            wl, wc = RSS.make_prefill(rcfg, L)(p64, r64(rb))
        el, ec = SS.make_prefill(tcfg, L)(m64, f64(tb))
        exact = (el, wl), (ec, wc)
    close(tl, rl, F32_TOL, exact=exact and exact[0])
    cache_diff(tc, rc, tcfg, exact and exact[1])
    rdec, tdec = jax.jit(RSS.make_decode(rcfg)), SS.make_decode(tcfg)
    for t in range(steps):
        tok, pos = nxt[:, t], P + prompt + t
        cl, cc = tdec(m, carry_cache(rc, tcfg), torch.from_numpy(tok), pos)
        if coarse:
            el, ec = tdec(m64, f64(carry_cache(rc, tcfg)), torch.from_numpy(tok), pos)
            with ref_float64():
                wl, wc = rdec64(p64, r64(rc), jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
            exact = (el, wl), (ec, wc)
        rl, rc = rdec(params, rc, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        close(cl, rl, F32_TOL, what=t, exact=exact and exact[0])
        cache_diff(cc, rc, tcfg, exact and exact[1])
        tl, tc = tdec(m, tc, torch.from_numpy(tok), pos)
        assert bool(torch.isfinite(tl).all())


def check_greedy(arch, prompt=16, steps=8, **kw):
    rcfg, tcfg, params, m = model(arch, **kw)
    rb, tb = batch(rcfg, 2, prompt, seed=2)
    L = prefix(rcfg) + prompt + steps + 1
    want = np.asarray(RSS.greedy_generate(rcfg, params, rb, steps=steps, cache_len=L))
    got = SS.greedy_generate(tcfg, m, tb, steps=steps, cache_len=L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def check_incremental(arch, S=12, **kw):
    """Token-by-token decode from an empty float32 cache reproduces the full
    forward (the reference's test, which fills an encoder-decoder's
    ``xk``/``xv`` from the encoder in float32)."""
    _, tcfg = cfgs(arch, **kw)
    m = TT.init_model(tcfg, seed=2, dtype=torch.float32, device="cpu")
    _, tb = batch(tcfg, 2, S, seed=4)
    x, _, _ = m.forward(tb)
    ref = m.unembed(x[:, -1]).numpy()
    cache = [{k: v.float() if v.is_floating_point() else v for k, v in c.items()}
             for c in m.init_cache(2, S)]
    if tcfg.is_encoder_decoder:
        with torch.no_grad():
            enc = m._encoder_forward(tb["frames"])
            for p, c in zip(m.layers, cache):
                c["xk"], c["xv"] = proj(enc, p["xk"]), proj(enc, p["xv"])
    for t in range(S):
        logits, cache = m.decode_step(tb["tokens"][:, t], cache, t)
    r = np.max(np.abs(logits.numpy() - ref)) / np.max(np.abs(ref))
    assert r < INCR_TOL, r


def check_bf16_serving(arch, S=24, **kw):
    _, tcfg = cfgs(arch, **kw)
    m = TT.init_model(tcfg, seed=4, dtype=torch.bfloat16, device="cpu")
    _, tb = batch(tcfg, 2, S, seed=5)
    x, _, _ = m.forward(tb)
    ref = m.unembed(x[:, -1]).float().numpy()
    P = prefix(tcfg)
    logits, _ = SS.make_prefill(tcfg, P + S + 4)(m, tb)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0.06, atol=0.05)
    _, cache = SS.make_prefill(tcfg, P + S)(m, {**tb, "tokens": tb["tokens"][:, :1]})
    for t in range(1, S):
        logits, cache = m.decode_step(tb["tokens"][:, t], cache, P + t)
    assert np.max(np.abs(logits.numpy() - ref)) / np.max(np.abs(ref)) < 0.25


def check_value_and_grad(arch, **kw):
    rcfg, tcfg, params, _ = model(arch, **kw)
    m = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg,
                                         device="cpu").requires_grad_(True)
    rb, tb = batch(rcfg, 2, 32, seed=0)
    (rl, _), rg = jax.value_and_grad(RTS.loss_fn, has_aux=True)(params, rcfg, rb)
    (tl, _), tg = TS.value_and_grad(m, tcfg, tb)
    ref_leaves = jax.tree.flatten_with_path(rg)[0]
    got = tree_leaves(tg)
    assert len(got) == len(ref_leaves)
    for (path, r), g in zip(ref_leaves, got):
        assert g.shape == r.shape and g.dtype == torch.float32
    if arch not in FLOAT32_COARSE:
        close(tl, rl, 1e-5)
        for (path, r), g in zip(ref_leaves, got):
            close(g, r, F32_TOL, what=jax.tree_util.keystr(path))
        return tg
    (el, _), eg = TS.value_and_grad(f64(m).requires_grad_(True), tcfg, f64(tb))
    with ref_float64():
        (wl, _), wg = jax.value_and_grad(RTS.loss_fn, has_aux=True)(r64(params), rcfg, r64(rb))
    close(tl, rl, 1e-5, exact=(el, wl))
    # each float64 leaf within F64_TOL of its max|grad| (or of 1e-9 of the
    # tree's largest, for the sLSTM's ``bi``: rounding alone in float64
    # too); leaf by leaf the two float32 errors are noise, so each is taken
    # against the tree's largest float64 grad, the port's worst against the
    # reference's
    want64 = [np64(w) for w in jax.tree.leaves(wg)]
    scale = max(np.abs(w).max() for w in want64)
    e_port = e_ref = 0.0
    for (path, r), g, e, w in zip(ref_leaves, got, tree_leaves(eg), want64):
        d64 = np.abs(np64(e) - w).max() / max(np.abs(w).max(), 1e-9 * scale)
        assert d64 <= F64_TOL, (jax.tree_util.keystr(path), d64)
        e_port = max(e_port, np.abs(np64(g) - w).max() / scale)
        e_ref = max(e_ref, np.abs(np64(r) - w).max() / scale)
    assert e_port <= max(F32_TOL, FLOOR_FACTOR * e_ref), (e_port, e_ref)
    return tg


def _params_close(got_model, want_params, lr, exact=None):
    """Parameters after a step: each entry within 1e-5 of its leaf's
    max|param| plus 1% of an lr, but at most 0.1% of a leaf's entries,
    which may be up to 2·lr off.  For a FLOAT32_COARSE config ``exact`` is
    (the port's float64 model, the reference's float64 parameters): the
    two within F64_TOL of max|param| plus 1e-4 of an lr, and the port's
    float32 entries are taken against the reference's float64, the bound
    raised to FLOOR_FACTOR × the reference's own worst float32 entry of the
    leaf where that is larger (a gradient inside float32's floor, whose
    sign decides AdamW's first step, leaves the step to rounding)."""
    got = jax.tree.flatten_with_path(convert.lm_params_to_numpy(got_model))[0]
    want = jax.tree.flatten_with_path(want_params)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    if exact is None:
        ex = [(None, None)] * len(want)
    else:
        ex = list(zip(jax.tree.leaves(convert.lm_params_to_numpy(exact[0])),
                      jax.tree.leaves(exact[1])))
    for (path, r), (_, g), (e, w) in zip(want, got, ex):
        r, g = np64(r), np64(g)
        d = np.abs(g - r)
        assert d.max() <= 2 * lr, jax.tree_util.keystr(path)
        lim = 1e-5 * np.abs(r).max() + 1e-2 * lr
        if w is not None:
            w = np64(w)
            d64 = np.abs(np64(e) - w).max()
            assert d64 <= F64_TOL * np.abs(w).max() + 1e-4 * lr, (jax.tree_util.keystr(path), d64)
            lim = max(lim, FLOOR_FACTOR * np.abs(r - w).max())
            d = np.abs(g - w)
        off = int((d > lim).sum())
        assert off <= 1e-3 * d.size, (jax.tree_util.keystr(path), off, d.size)


def check_train_steps(arch, **kw):
    """Three steps of the config's optimizer, each from the reference's
    state after the one before."""
    rcfg, tcfg = cfgs(arch, **kw)
    coarse = arch in FLOAT32_COARSE
    params = ref_params(arch)
    ropt = RO.opt_init(params, rcfg.optimizer)
    rstep = jax.jit(RTS.make_train_step(rcfg, lr=LR))
    if coarse:
        with ref_float64():
            rstep64 = jax.jit(RTS.make_train_step(rcfg, lr=LR))
    tstep = TS.make_train_step(tcfg, lr=LR)
    for i in range(3):
        m, topt = convert.lm_train_state_from_reference(
            jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, ropt), tcfg, device="cpu")
        rb, tb = batch(rcfg, 4, 24, seed=10 + i)
        exact, wm = None, {}
        if coarse:
            m64, _, em = tstep(f64(m).requires_grad_(True), f64(topt), f64(tb))
            with ref_float64():
                w64, _, wm = rstep64(r64(params), r64(ropt), r64(rb))
            exact = (m64, w64)
        params, ropt, rm = rstep(params, ropt, rb)
        m, topt, tm = tstep(m, topt, tb)
        for k in rm:
            close(tm[k], rm[k], 1e-4 if k == "grad_norm" else 1e-5, what=(i, k),
                  exact=(em[k], wm[k]) if coarse else None)
        _params_close(m, params, LR, exact)


def check_remat_bitwise(arch, **kw):
    toks = None
    out = {}
    for policy in ("none", "full", "dots"):
        _, tcfg = cfgs(arch, remat=policy, **kw)
        m = TT.init_model(tcfg, seed=3, dtype=torch.float32, device="cpu").requires_grad_(True)
        if toks is None:
            _, toks = batch(tcfg, 2, 32, seed=2)
        (loss, _), g = TS.value_and_grad(m, tcfg, toks)
        out[policy] = (loss, tree_leaves(g))
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[policy][1], out["none"][1])), policy


def check_serve_main(arch, capsys):
    out = SS.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                   "--prompt-len", "8", "--gen", "4"])
    assert out.shape == (2, 4) and out.dtype == torch.int32
    assert f"arch={tget(arch).name} device=cpu generated [2, 4]" in capsys.readouterr().out


def check_train_main(arch, tmp_path, capsys):
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    TRAIN.main(args + ["--steps", "2"])
    m, opt = TRAIN.main(args + ["--steps", "4", "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert int(opt.step) == 4
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(m.params))
    # the uninterrupted run: bitwise the resumed one
    m2, opt2 = TRAIN.main(args + ["--steps", "4", "--ckpt-dir", str(tmp_path / "straight")])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(m.params), tree_leaves(m2.params)))
