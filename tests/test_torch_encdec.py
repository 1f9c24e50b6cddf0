"""The port's encoder-decoder and frontend paths (``models.transformer``'s
encoder, cross attention, learned positions and the vision stub's patch
prefix; ``serve_step``'s prefix positions) against the JAX reference on the
CPU: whisper-base (a 2-layer bidirectional encoder over the audio stub's
24 frames, learned positions, LayerNorm, cross attention in each decoder
block) and internvl2-1b (8 patch embeddings before the text) at
``smoke()`` size.

Tolerances: ``tests/lm_parity.py``'s (the dense family's; whisper's
smoke weights make float32 itself coarse, so its model comparisons hold
the port in float64 to the reference in float64, stated there); the encoder
alone within ``F32_TOL`` = 1e-4 of max|out|, with float32 weights and with
bf16 weights over float32 frames, where both frameworks promote the
encoder's arithmetic to float32 (its weights are bf16 values, exact in
float32).  Incremental decode against the forward (float32, 2e-3) runs on
whisper: internvl's patches can enter a cache only through a prefill,
which keeps their K/V in bf16, so its prefill-then-decode path is held to
the reference's (``test_prefill_and_decode_match_in_float32``) and to its
own forward at the bf16 serving tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as LP
from repro.models import spec as RSPEC
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch import serve_step as SS
from repro_torch.configs import get_config as tget
from repro_torch.models import transformer as TT

ARCHS = ["whisper_base", "internvl2_1b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_reference_tree(arch):
    leaves = dict(LP.check_param_specs(arch, full=False))
    if arch == "whisper_base":
        cfg = tget(arch).smoke()
        assert leaves["pos_embed"].shape == (RT.MAX_LEARNED_POS, cfg.d_model) == (
            TT.MAX_LEARNED_POS, cfg.d_model)
        assert leaves["encoder/pos"].shape == (cfg.encoder_seq, cfg.d_model)
        assert leaves["encoder/layers/b0/wq"].shape[0] == cfg.encoder_layers
        assert {"lnx/scale", "lnx/bias", "xq", "xk", "xv", "xo"} <= {
            p.removeprefix("layers/b0/") for p in leaves}
    else:
        assert not any(p.startswith(("encoder", "pos_embed")) for p in leaves)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_and_runs_in_the_promoted_dtype(dtype):
    rcfg, tcfg = LP.cfgs("whisper_base")
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    params = RSPEC.init_params(RT.param_specs(rcfg, dtype=jdt), jax.random.key(3))
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    frames = np.random.default_rng(0).normal(size=(2, rcfg.encoder_seq, rcfg.d_model)).astype(np.float32)
    want = RT._encoder_forward(params, rcfg, jnp.asarray(frames))
    got = model._encoder_forward(torch.from_numpy(frames))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert LP.rel(got, want) <= LP.F32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_in_float32(arch):
    LP.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_in_float32(arch):
    LP.check_prefill_and_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_tokens_equal_in_float32(arch):
    """internvl's decode starts after the patches and the text, as the
    reference's ``greedy_generate`` counts positions."""
    LP.check_greedy(arch)


def test_incremental_decode_matches_forward():
    LP.check_incremental("whisper_base")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving_holds_to_its_own_forward(arch):
    LP.check_bf16_serving(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_value_and_grad_matches_in_float32(arch):
    g = LP.check_value_and_grad(arch)
    if arch == "whisper_base":  # the encoder and its positions get gradients
        assert g["encoder"]["pos"].abs().max() > 0 and g["pos_embed"].abs().max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_over_three_steps(arch):
    LP.check_train_steps(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_bitwise_equal_grads(arch):
    LP.check_remat_bitwise(arch)


def test_prefix_len_counts_the_patches_only_when_given():
    cfg = tget("internvl2_1b").smoke()
    toks = torch.zeros(2, 3, dtype=torch.int32)
    assert SS.prefix_len(cfg, {"tokens": toks, "patches": torch.zeros(2, 8, 64)}) == cfg.vis_tokens
    assert SS.prefix_len(cfg, {"tokens": toks}) == 0
    assert SS.prefix_len(tget("whisper_base").smoke(), {"tokens": toks, "patches": None}) == 0


def test_internvl_without_patches_serves_text_alone():
    """Without ``patches`` the vision config is its text backbone: positions
    start at 0, as in the reference."""
    rcfg, tcfg, params, model = LP.model("internvl2_1b")
    toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (2, 10)).astype(np.int32)
    from repro.serving import serve_step as RSS

    want = np.asarray(RSS.greedy_generate(rcfg, params, {"tokens": jnp.asarray(toks)}, steps=5,
                                          cache_len=16))
    got = SS.greedy_generate(tcfg, model, {"tokens": torch.from_numpy(toks)}, steps=5, cache_len=16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_main_runs_on_the_cpu(arch, capsys):
    LP.check_serve_main(arch, capsys)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_runs_and_resumes_on_the_cpu(arch, tmp_path, capsys):
    LP.check_train_main(arch, tmp_path, capsys)
