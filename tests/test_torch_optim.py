"""The port's optimizers, confidence-bounded gradient accumulation, train
checkpoints and training driver (``repro_torch.training.optimizer``,
``training.grad_estimator``, ``ckpt.save_train_state``/``load_train_state``,
``repro_torch.train``) against the JAX reference on the CPU.

Inputs are numpy draws from a seed, handed to both packages.

Tolerances:
* AdamW over 5 steps: every leaf of the parameters and the state within 2
  float32 ulps of the reference run one operation at a time, entry by
  entry; within 2 ulps of max|leaf| of the jitted reference (XLA fuses
  ``a*b + c`` into FMAs, which moves a moment that cancels to near zero
  by many ulps of itself).
* Adafactor over 5 steps: within 4 ulps of max|leaf|, of both.  Two of
  its primitives differ between the frameworks — XLA's ``rsqrt`` from
  torch's by up to 2 ulps, XLA's ``pow`` (``beta = 1 - t^-0.8``) by 1 ulp
  (``test_adafactor_primitives_differ_by_these_ulps`` measures both) — and
  each step's statistics carry them forward.
* ``accumulate_until_confident``: the same ``n_used`` and history; grads
  within 1e-6 of max|grad| (fake grads) or 5e-4 (the model's, float32: on
  these weights the port's own float32 grads lie 3.1e-4 of max|grad| from
  its float64 ones — near one-hot attention rows amplify rounding).
  Over the model the losses agree to 1e-5 and the widths to 5e-2: the 16
  losses lie within 1e-3 of each other, and the float32 variance term
  ``n·Σx² − (Σx)²`` cancels all but a few bits, in both packages (measured
  1.2% apart).
* checkpoints and resumed training: bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RCK
from repro.configs import get_config as rget
from repro.models import spec as RSPEC
from repro.models import transformer as RT
from repro.training import grad_estimator as RGE
from repro.training import optimizer as RO
from repro.training import train_step as RTS
from repro_torch import ckpt as TCK
from repro_torch import convert
from repro_torch import train as TTRAIN
from repro_torch.configs import get_config as tget
from repro_torch.data.tokens import token_batches
from repro_torch.models import transformer as TT
from repro_torch.training import grad_estimator as TGE
from repro_torch.training import optimizer as TO
from repro_torch.training import train_step as TS
from repro_torch.uda import tree_leaves

#: stacked [n, d] and [n, d, h, e] leaves, a matrix, a vector and a [d, 1]
#: column: Adafactor factors the first three and not the last two
SHAPES = {"col": (32, 1), "mat": (40, 24), "stack_nd": (3, 64),
          "stack_ndhe": (2, 16, 4, 8), "vec": (48,)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    p0 = {k: (rng.normal(size=s) * 0.5).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10 ** rng.uniform(-3, 1, size=s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]
    return p0, grads


def _ulps(got, want, of_max):
    g = np.asarray(got, np.float32).astype(np.float64)
    w = np.asarray(want, np.float32)
    scale = np.abs(w).max() if of_max else np.maximum(np.abs(w), np.abs(g).astype(np.float32))
    return float((np.abs(g - w) / np.spacing(np.float32(scale) if of_max else scale)).max())


WIDTH_RTOL = 5e-2


def _run_both(kind, jit):
    p0, grads = _trees(0)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    rs = RO.opt_init(rp, kind)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = TO.opt_init(tp, kind)
    upd = lambda g, s, p: RO.opt_update(g, s, p, kind, lr=1e-2)  # noqa: E731
    upd = jax.jit(upd) if jit else upd
    for g in grads:
        rp, rs = upd({k: jnp.asarray(v) for k, v in g.items()}, rs, rp)
        tp, ts = TO.opt_update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, kind,
                               lr=1e-2)
    assert int(ts.step) == int(rs.step) == 5 and ts.step.dtype == torch.int32
    ref = list(rp.values()) + jax.tree.leaves(rs)[1:]
    got = list(tp.values()) + tree_leaves(ts)[1:]
    assert [tuple(t.shape) for t in got] == [a.shape for a in ref]
    assert all(t.dtype == torch.float32 for t in got)
    return ref, got


@pytest.mark.parametrize("jit", [False, True], ids=["op-by-op", "jit"])
def test_adamw_matches_within_two_ulps(jit):
    ref, got = _run_both("adamw", jit)
    for r, g in zip(ref, got):
        assert _ulps(g.numpy(), r, of_max=jit) <= 2.0


@pytest.mark.parametrize("jit", [False, True], ids=["op-by-op", "jit"])
def test_adafactor_matches_within_four_ulps_of_max(jit):
    ref, got = _run_both("adafactor", jit)
    for r, g in zip(ref, got):
        assert _ulps(g.numpy(), r, of_max=True) <= 4.0


def test_adafactor_primitives_differ_by_these_ulps():
    """What the Adafactor tolerance rests on: ``lax.rsqrt`` and ``pow``
    against torch's on the same float32 inputs."""
    y = np.abs(np.random.default_rng(1).normal(size=10_000)).astype(np.float32) + 1e-3
    r = _ulps(torch.rsqrt(torch.from_numpy(y)).numpy(), jax.lax.rsqrt(jnp.asarray(y)), of_max=False)
    t = np.arange(1, 100, dtype=np.float32)
    p = _ulps((torch.from_numpy(t) ** -0.8).numpy(), jnp.asarray(t) ** -0.8, of_max=False)
    assert r <= 2.0 and p <= 1.0


def test_factored_dims_and_init_shapes():
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    st = TO.adafactor_init(params)
    rst = RO.adafactor_init({k: jnp.zeros(s) for k, s in SHAPES.items()})
    for k in SHAPES:
        assert TO._factored_dims(SHAPES[k]) == RO._factored_dims(SHAPES[k])
        assert tuple(st.vr[k].shape) == rst.vr[k].shape and tuple(st.vc[k].shape) == rst.vc[k].shape
    a = TO.adamw_init(params)
    assert a.master["mat"] is not params["mat"] and torch.equal(a.master["mat"], params["mat"])


# --------------------------------------------------------------------------- the estimator

@pytest.mark.parametrize("n_total", [4, 16, 100])
def test_ci_relative_width_matches_on_a_grid(n_total):
    rng = np.random.default_rng(n_total)
    for n in range(2, n_total + 1, max(1, n_total // 7)):
        x = (rng.normal(size=n) * 0.3 + 5.0).astype(np.float64)
        s, sq = float(x.sum()), float((x * x).sum())
        for conf in (0.9, 0.95):
            want = float(RGE.ci_relative_width(jnp.asarray(s), jnp.asarray(sq), n, n_total, conf))
            got = TGE.ci_relative_width(s, sq, n, n_total, conf)
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-6 * abs(want) + 1e-12, (n, conf)
    assert float(TGE.ci_relative_width(5.0, 25.0, 1, n_total)) == float("inf")


def _fake_grad_fns(noise):
    """A seeded grad_fn for each package: microbatch i's loss is 5 +
    noise·z_i, its grads a fixed tree times (1 + i/10)."""
    rng = np.random.default_rng(3)
    z = rng.normal(size=16)
    base = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}

    def ref(params, mb):
        i = int(mb["i"])
        return (jnp.asarray(5.0 + noise * z[i], jnp.float32),
                {k: jnp.asarray(v) * (1 + i / 10) for k, v in base.items()})

    def port(params, mb):
        i = int(mb["i"])
        return (torch.tensor(5.0 + noise * z[i], dtype=torch.float32),
                {k: torch.from_numpy(v) * (1 + i / 10) for k, v in base.items()})

    return ref, port


@pytest.mark.parametrize("noise,target", [(0.01, 0.05), (1.0, 0.05), (1.0, 0.5), (0.3, 0.0)])
def test_accumulate_until_confident_with_a_fake_grad_fn(noise, target):
    ref_fn, port_fn = _fake_grad_fns(noise)
    ids = np.arange(16, dtype=np.int32)
    rg, rn, rh = RGE.accumulate_until_confident(ref_fn, None, {"i": jnp.asarray(ids)},
                                                target_rel_width=target)
    tg, tn, th = TGE.accumulate_until_confident(port_fn, None, {"i": torch.from_numpy(ids)},
                                                target_rel_width=target)
    assert tn == rn and [h["n"] for h in th] == [h["n"] for h in rh]
    for a, b in zip(th, rh):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-7)
        assert a["rel_width"] == pytest.approx(b["rel_width"], rel=1e-6)
    for k in rg:
        r = np.asarray(rg[k])
        assert np.abs(tg[k].numpy() - r).max() <= 1e-6 * np.abs(r).max()


def test_accumulate_until_confident_over_the_smoke_model():
    """``examples/adaptive_batch.py``'s step on both packages: the same
    float32 weights, 16 microbatches of 4 x 32 tokens."""
    rcfg, tcfg = rget("smollm_135m").smoke(), tget("smollm_135m").smoke()
    params = RSPEC.init_params(RT.param_specs(rcfg, dtype=jnp.float32), jax.random.key(0))
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg,
                                             device="cpu").requires_grad_(True)
    toks = np.random.default_rng(5).integers(0, rcfg.vocab_size, (16, 4, 32)).astype(np.int32)

    @jax.jit
    def rgrad(p, mb):
        (loss, _), g = jax.value_and_grad(RTS.loss_fn, has_aux=True)(p, rcfg, mb)
        return loss, g

    def tgrad(m, mb):
        (loss, _), g = TS.value_and_grad(m, tcfg, mb)
        return loss, g

    for target in (0.08, 1e-4):  # fires at min_micro; takes all 16
        rg, rn, rh = RGE.accumulate_until_confident(rgrad, params, {"tokens": jnp.asarray(toks)},
                                                    target_rel_width=target)
        tg, tn, th = TGE.accumulate_until_confident(tgrad, model, {"tokens": torch.from_numpy(toks)},
                                                    target_rel_width=target)
        assert tn == rn and len(th) == len(rh)
        for a, b in zip(th, rh):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
            assert a["rel_width"] == pytest.approx(b["rel_width"], rel=WIDTH_RTOL)
        for (path, r), g in zip(jax.tree.flatten_with_path(rg)[0], tree_leaves(tg)):
            r = np.asarray(r)
            assert np.abs(g.numpy() - r).max() <= 5e-4 * np.abs(r).max(), jax.tree_util.keystr(path)
    assert rn > 2  # the tight target consumed more than min_micro


# --------------------------------------------------------------------------- checkpoints

def _train_state(dtype=torch.bfloat16, arch="deepseek_7b", **kw):
    cfg = dataclasses.replace(tget(arch).smoke(), **kw)
    model, opt = TS.init_train_state(cfg, seed=0, dtype=dtype, device="cpu")
    return cfg, model, opt


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_state_round_trips_bitwise(kind, tmp_path):
    cfg, model, opt = _train_state(optimizer=kind)
    step = TS.make_train_step(cfg, lr=3e-3)
    batch, cursor = next(token_batches(cfg, 4, 16, start=7, device="cpu"))
    model, opt, _ = step(model, opt, batch)
    path = tmp_path / "t.ckpt"
    TCK.save_train_state(path, model.params, opt, 3, cursor)
    params, opt2, s, c = TCK.load_train_state(path, model.params, opt, device="cpu")
    assert (s, c) == (3, 8) and type(opt2) is type(opt)
    a, b = tree_leaves({"p": model.params, "o": opt}), tree_leaves({"p": params, "o": opt2})
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert params["embed"].dtype == torch.bfloat16 and int(opt2.step) == 1


def test_foreign_and_mismatched_train_states_are_refused(tmp_path):
    cfg, model, opt = _train_state(dtype=torch.float32, arch="smollm_135m")
    # the JAX package's own msgpack train checkpoint
    rcfg = rget("smollm_135m").smoke()
    rp = RSPEC.init_params(RT.param_specs(rcfg, dtype=jnp.float32), jax.random.key(0))
    RCK.save_train_state(tmp_path / "jax.ckpt", rp, RO.opt_init(rp, "adamw"), 2, 5)
    with pytest.raises(ValueError, match="foreign checkpoint"):
        TCK.load_train_state(tmp_path / "jax.ckpt", model.params, opt, device="cpu")
    TCK.save_train_state(tmp_path / "ok.ckpt", model.params, opt, 0, 0)
    with pytest.raises(ValueError, match="does not match"):
        TCK.load_train_state(tmp_path / "ok.ckpt", model.params, TO.adafactor_init(model.params),
                             device="cpu")
    TCK.save_envelope(tmp_path / "old.ckpt", {"kind": "train_state", "version": 99}, b"")
    with pytest.raises(ValueError, match="unsupported train state version"):
        TCK.load_train_state(tmp_path / "old.ckpt", model.params, opt, device="cpu")
    TCK.save_envelope(tmp_path / "sess.ckpt", {"version": 1}, b"")
    with pytest.raises(ValueError, match="not a training state"):
        TCK.load_train_state(tmp_path / "sess.ckpt", model.params, opt, device="cpu")


def _steps(cfg, model, opt, n, cursor):
    step = TS.make_train_step(cfg, lr=3e-3)
    batches = token_batches(cfg, 4, 16, start=cursor, device="cpu")
    for _ in range(n):
        batch, cursor = next(batches)
        model, opt, _ = step(model, opt, batch)
    return model, opt, cursor


@pytest.mark.parametrize("micro", [1, 2])
def test_resumed_training_is_bitwise_uninterrupted_training(micro, tmp_path):
    """4 steps equal 2 steps, a save, a load into a new model and 2 more."""
    cfg, model, opt = _train_state(train_microbatches=micro)
    full = _steps(cfg, model, opt, 4, 0)
    _, model, opt = _train_state(train_microbatches=micro)
    model, opt, cursor = _steps(cfg, model, opt, 2, 0)
    TCK.save_train_state(tmp_path / "r.ckpt", model.params, opt, 2, cursor)
    params, opt, step, cursor = TCK.load_train_state(tmp_path / "r.ckpt", model.params, opt,
                                                     device="cpu")
    resumed = _steps(cfg, TT.Transformer(cfg, params).requires_grad_(True), opt, 2, cursor)
    assert resumed[2] == full[2] == 4 and step == 2
    a = tree_leaves({"p": full[0].params, "o": full[1]})
    b = tree_leaves({"p": resumed[0].params, "o": resumed[1]})
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_train_main_checkpoints_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.train --smoke --device cpu --steps 4
    --ckpt-every 2``, then ``--resume`` to 6 steps, equals 6 steps at once."""
    common = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16"]
    a, b = tmp_path / "a", tmp_path / "b"
    TTRAIN.main(common + ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", str(a)])
    out = capsys.readouterr().out
    assert "checkpointed at step 2" in out and "checkpointed at step 4" in out and "done" in out
    m1, o1 = TTRAIN.main(common + ["--steps", "6", "--resume", "--ckpt-dir", str(a)])
    assert "resumed from step 4" in capsys.readouterr().out
    m2, o2 = TTRAIN.main(common + ["--steps", "6", "--ckpt-every", "100", "--ckpt-dir", str(b)])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves({"p": m1.params, "o": o1}),
                                                 tree_leaves({"p": m2.params, "o": o2})))
    cfg = tget("smollm_135m").smoke()
    like = TS.init_train_state(cfg, seed=0, dtype=torch.float32, device="cpu")
    _, _, step, cursor = TCK.load_train_state(a / "smollm_135m.ckpt", like[0].params, like[1],
                                              device="cpu")
    assert (step, cursor) == (6, 6)


def test_grad_estimator_main_runs_on_the_cpu_when_asked(capsys):
    used = TGE.main(["--device", "cpu", "--steps", "2"])
    assert len(used) == 2 and all(2 <= n <= 16 for n in used)
    assert "used 2/16 microbatches" in capsys.readouterr().out


def test_cuda_requested_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = tget("smollm_135m").smoke()
    with pytest.raises(RuntimeError, match="cuda"):
        TS.init_train_state(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        TTRAIN.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        TGE.main(["--steps", "1"])
    _, model, opt = _train_state(dtype=torch.float32, arch="smollm_135m")
    TCK.save_train_state(tmp_path / "c.ckpt", model.params, opt, 0, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        TCK.load_train_state(tmp_path / "c.ckpt", model.params, opt)


def test_training_modules_import_no_jax():
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch.training.train_step, repro_torch.training.optimizer, "
            "repro_torch.training.grad_estimator, repro_torch.train, repro_torch.ckpt; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": str(src), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
