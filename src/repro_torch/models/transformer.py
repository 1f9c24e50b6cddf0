"""The LM: parameter specs, forward (prefill and training), the chunked
cross-entropy, decode caches and the decode step, for every family of
``configs/``.

Port of ``repro/models/transformer.py``.  The config's ``block_pattern`` is
cycled over ``num_layers``; each block type owns its parameters, its decode
cache and its train/decode apply, dispatched on the layer type as the
reference's ``_block_specs``/``_block_train``/``_block_cache``/
``_block_decode`` do:

  attn           global causal attention + dense MLP or routed experts
                 (``models.moe``)
  attn_chunked   Llama-4's chunked local attention, or a sliding window of
                 ``local_window`` in the hybrid family (ring cache)
  rglru          RG-LRU temporal mixing + dense MLP (``models.recurrent``)
  mlstm / slstm  xLSTM blocks, self-contained (``models.recurrent``,
                 ``models.mlstm_chunked``)

RMSNorm or LayerNorm; RoPE (on every attention layer, as in the reference),
learned positions (``pos_embed`` [MAX_LEARNED_POS, d]) or none; tied or
untied unembedding; qk-norm; a bf16 or int8 KV cache for ``attn``.  An
encoder-decoder config (whisper) runs a bidirectional encoder over the
audio stub's ``frames`` and cross attention in every decoder block; a
vision-stub config (internvl2) prepends the batch's ``patches``, cast to the
activations' dtype, to the embedded tokens.  The encoder runs in the dtype
the frames and its weights promote to (float32 frames: float32, as the
reference's ``jnp`` promotion has it), and its cross K/V are cached in bf16.

The reference scans its layer groups over parameters stacked on a leading
"layers" axis; here the parameters are those same stacked leaves, each
group takes its slices inside the forward and the scan is a loop, under
the config's ``remat`` policy (``torch.utils.checkpoint``) when the
forward builds a graph; the encoder's layers likewise.
:class:`Transformer`'s methods carry the reference's function names:
``forward(batch, cache_len=)``, ``unembed``, ``init_cache``,
``decode_step``; :func:`xent_loss` is the reference's.

Left out on purpose: ``pin_batch_activation`` and ``_pin_replicated_heads``
are GSPMD sharding constraints against the ambient mesh.  The port's
``repro_torch.sharding.ambient_mesh`` is always ``None``: the port places
parameters by the rule table (``sharding.param_pspecs``) for the dry run,
but executes a model on one card only, so there is nothing to pin against.

Caches: a list with one dict per layer, in layer order (the reference's
tree of stacked leaves comes back through
``repro_torch.convert.lm_cache_to_numpy``).  The prefill's K/V are stored
in bf16 whatever the parameters' dtype, as the reference's
``_kv_to_cache`` does; ``decode_step`` takes a bf16, float32 or int8
cache.  An ``attn_chunked`` layer's cache holds W slots (the window, at
most the cache length): position ``pos`` lives in slot ``pos % W`` and
``kpos`` [W] int32 names the position in each slot (-1 where empty).  An
encoder-decoder's attention layers add ``xk``/``xv`` [B, encoder_seq, K,
dh] (bf16).  A recurrent layer's cache is its float32 state; the prefill
returns it only when ``cache_len`` > 0.  ``decode_step`` updates the cache
IN PLACE and returns the same list: attention layers write the token's K/V
into their tensors, recurrent layers replace the entries of their own
state dict (the dict object stays); a caller that needs the old cache
copies it first.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import recurrent as R
from repro_torch.models.layers import (acc_dtype, apply_norm, apply_rope, decode_attention,
                                       flash_attention, mlp, proj, rms_norm)
from repro_torch.models.moe import moe_mlp
from repro_torch.models.spec import ParamSpec, init_params
from repro_torch.uda import tree_map

_F32 = torch.float32
MAX_LEARNED_POS = 32768
_ATTN = ("attn", "attn_chunked")


def check_per_example(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` where a per-example loss is not a function of
    the example alone: the experts' capacity drops a token's pair by its
    rank among the pairs of its dispatch group, so an MoE model's loss on
    one example depends on which examples share its forward."""
    if cfg.num_experts:
        raise ValueError(
            f"{cfg.name}: no per-example loss over an MoE model — under the experts' "
            f"capacity (factor {cfg.expert_capacity_factor}) a token is dropped by its rank "
            f"among the tokens of its dispatch group, so an example's loss depends on "
            f"which examples share its forward, not on the example alone")


# =========================================================================== specs

def _mlp_specs(cfg: ArchConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.num_experts:
        E = cfg.num_experts
        s = {
            "router": ParamSpec((d, E), ("embed", None), dtype=torch.float32),
            "wi": ParamSpec((E, d, f), ("experts", "embed", "mlp"), dtype=dtype),
            "wo": ParamSpec((E, f, d), ("experts", "mlp", "embed"), dtype=dtype),
        }
        if cfg.mlp_gated:
            s["wg"] = ParamSpec((E, d, f), ("experts", "embed", "mlp"), dtype=dtype)
        return s
    s = {
        "wi": ParamSpec((d, f), ("embed", "mlp"), dtype=dtype),
        "wo": ParamSpec((f, d), ("mlp", "embed"), dtype=dtype),
    }
    if cfg.mlp_gated:
        s["wg"] = ParamSpec((d, f), ("embed", "mlp"), dtype=dtype)
    return s


def _attn_specs(cfg: ArchConfig, dtype, cross: bool = False):
    d, H, K, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    s = {
        "ln1": R.norm_spec(d, cfg.norm, dtype),
        "wq": ParamSpec((d, H, dh), ("embed", "heads", None), dtype=dtype),
        "wk": ParamSpec((d, K, dh), ("embed", "kv", None), dtype=dtype),
        "wv": ParamSpec((d, K, dh), ("embed", "kv", None), dtype=dtype),
        "wo": ParamSpec((H, dh, d), ("heads", None, "embed"), dtype=dtype),
        "ln2": R.norm_spec(d, cfg.norm, dtype),
        "mlp": _mlp_specs(cfg, dtype),
    }
    if cfg.qk_norm:
        s["qn"] = ParamSpec((dh,), (None,), "ones", dtype=dtype)
        s["kn"] = ParamSpec((dh,), (None,), "ones", dtype=dtype)
    if cross:
        s["lnx"] = R.norm_spec(d, cfg.norm, dtype)
        s["xq"] = ParamSpec((d, H, dh), ("embed", "heads", None), dtype=dtype)
        s["xk"] = ParamSpec((d, K, dh), ("embed", "kv", None), dtype=dtype)
        s["xv"] = ParamSpec((d, K, dh), ("embed", "kv", None), dtype=dtype)
        s["xo"] = ParamSpec((H, dh, d), ("heads", None, "embed"), dtype=dtype)
    return s


def _block_specs(cfg: ArchConfig, ltype: str, dtype, cross: bool = False):
    if ltype in _ATTN:
        return _attn_specs(cfg, dtype, cross=cross)
    if ltype == "rglru":
        s = R.rglru_specs(cfg, dtype)
        s["ln2"] = R.norm_spec(cfg.d_model, cfg.norm, dtype)
        s["mlp"] = _mlp_specs(cfg, dtype)
        return s
    if ltype == "mlstm":
        return R.mlstm_specs(cfg, dtype)
    if ltype == "slstm":
        return R.slstm_specs(cfg, dtype)
    raise ValueError(ltype)


def _stack_specs(tree, n: int):
    if isinstance(tree, ParamSpec):
        return dataclasses.replace(tree, shape=(n,) + tree.shape,
                                   logical=("layers",) + tree.logical)
    return {k: _stack_specs(v, n) for k, v in tree.items()}


def _layer_layout(cfg: ArchConfig):
    """(pattern, n_groups, tail_types)."""
    pat = cfg.block_pattern
    n_groups = cfg.num_layers // len(pat)
    tail = cfg.layer_types()[n_groups * len(pat):]
    return pat, n_groups, tail


def param_specs(cfg: ArchConfig, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The reference's parameter tree: ``embed``, ``layers`` (each pattern
    entry ``b{i}`` stacked over the layer groups), ``tail``, ``ln_f``; when
    the embeddings are not tied, ``lm_head``; with learned positions,
    ``pos_embed`` [MAX_LEARNED_POS, d]; for an encoder-decoder, the
    decoder's attention blocks with cross attention (``lnx``, ``xq``,
    ``xk``, ``xv``, ``xo``) and the ``encoder`` (``pos`` [encoder_seq, d],
    its blocks stacked as ``layers/b0``, ``ln_f``)."""
    d, V = cfg.d_model, cfg.vocab_padded
    pat, n_groups, tail = _layer_layout(cfg)
    cross = cfg.is_encoder_decoder
    group = {f"b{i}": _block_specs(cfg, lt, dtype, cross=cross) for i, lt in enumerate(pat)}
    specs: Dict[str, Any] = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), "embed", scale=0.02, dtype=dtype),
        "layers": _stack_specs(group, n_groups) if n_groups else {},
        "tail": {f"t{i}": _block_specs(cfg, lt, dtype, cross=cross) for i, lt in enumerate(tail)},
        "ln_f": R.norm_spec(d, cfg.norm, dtype),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, V), ("embed", "vocab"), scale=1.0, dtype=dtype)
    if cfg.pos == "learned":
        specs["pos_embed"] = ParamSpec((MAX_LEARNED_POS, d), (None, "embed"), "embed",
                                       scale=0.02, dtype=dtype)
    if cfg.is_encoder_decoder:
        specs["encoder"] = {
            "pos": ParamSpec((cfg.encoder_seq, d), (None, "embed"), "embed", scale=0.02,
                             dtype=dtype),
            "layers": _stack_specs({"b0": _attn_specs(cfg, dtype)}, cfg.encoder_layers),
            "ln_f": R.norm_spec(d, cfg.norm, dtype),
        }
    return specs


# =========================================================================== the module

class ParamTree(nn.Module):
    """A dict tree of tensors as a module: sub-dicts are child modules,
    tensors parameters, frozen until ``requires_grad_``;
    ``tree["ln1"]["scale"]`` reads as the reference's parameter dicts do."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._keys = sorted(tree)
        for k in self._keys:
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)

    def tree(self) -> Dict[str, Any]:
        """The parameters as a nested dict, keys sorted at every level (the
        order of ``jax.tree.leaves`` on the reference's tree)."""
        return {k: self[k].tree() if isinstance(self[k], ParamTree) else self[k]
                for k in self._keys}


def _unstack(tree, n: int) -> list:
    """A dict tree of [n, ...] tensors -> n trees of their slices, through
    one ``unbind`` a leaf (its backward stacks the n gradients once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep every matmul's output, recompute the rest (the
    reference's ``jax.checkpoint_policies.dots_saveable``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, policy: str):
    """The reference's ``_remat_wrap``: ``"none"`` keeps every activation,
    ``"full"`` recomputes the whole wrapped function in the backward,
    ``"dots"`` recomputes all but the matmuls' outputs.  Values do not
    change, only what the backward keeps."""
    if policy == "none":
        return fn
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, context_fn=ctx)
    if policy != "full":
        raise ValueError(f"remat {policy!r}: use 'full', 'dots' or 'none'")
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _out(o, w):
    """``o [..., H, dh] @ w [H, dh, d] -> [..., d]``, in the dtype the two
    promote to."""
    dt = torch.promote_types(o.dtype, w.dtype)
    return o.reshape(*o.shape[:-2], -1).to(dt) @ w.reshape(-1, w.shape[-1]).to(dt)


def _quant(x):
    """Per-row int8 quantization over the last axis: ``s = max|x|/127 +
    1e-8`` in float32, ``q = round(x/s)`` (half to even, as ``jnp.round``)."""
    x32 = x.to(_F32)
    s = torch.amax(torch.abs(x32), dim=-1) / 127.0 + 1e-8
    q = torch.round(x32 / s[..., None]).to(torch.int8)
    return q, s


def _dequant(q, s, dtype):
    """The reference's dequantization: the int8 values times the scales,
    both cast to bf16, then cast to the query's ``dtype``.  The product of
    two bf16 numbers is exact in float32: for a float32 query the compiled
    reference keeps it exact (XLA drops the round trip through bf16); for a
    bf16 query it is the bf16 product."""
    if dtype == _F32:
        return q.to(_F32) * s[..., None].to(torch.bfloat16).to(_F32)
    return (q.to(torch.bfloat16) * s[..., None].to(torch.bfloat16)).to(dtype)


def _window(cfg: ArchConfig) -> int:
    """An ``attn_chunked`` layer's window: the hybrid family's sliding
    ``local_window``, else Llama-4's ``attn_chunk``."""
    return cfg.local_window if cfg.family == "hybrid" else cfg.attn_chunk


def _attn_cache(cfg: ArchConfig, ltype: str, batch: int, seq_len: int, dev):
    K, dh = cfg.num_kv_heads, cfg.head_dim_
    if ltype == "attn_chunked":
        W = min(_window(cfg), seq_len)
        return {"k": torch.zeros((batch, W, K, dh), dtype=torch.bfloat16, device=dev),
                "v": torch.zeros((batch, W, K, dh), dtype=torch.bfloat16, device=dev),
                "kpos": torch.full((W,), -1, dtype=torch.int32, device=dev)}
    shape = (batch, seq_len, K, dh)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.zeros(shape[:-1], dtype=_F32, device=dev),
                "vs": torch.zeros(shape[:-1], dtype=_F32, device=dev)}
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}


def _block_cache(cfg: ArchConfig, ltype: str, batch: int, seq_len: int, dev):
    if ltype in _ATTN:
        c = _attn_cache(cfg, ltype, batch, seq_len, dev)
        if cfg.is_encoder_decoder:
            K, dh = cfg.num_kv_heads, cfg.head_dim_
            for k in ("xk", "xv"):
                c[k] = torch.zeros((batch, cfg.encoder_seq, K, dh), dtype=torch.bfloat16, device=dev)
        return c
    if ltype == "rglru":
        return R.rglru_state(cfg, batch, dev)
    if ltype == "mlstm":
        return R.mlstm_state(cfg, batch, dev)
    if ltype == "slstm":
        return R.slstm_state(cfg, batch, dev)
    raise ValueError(ltype)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device="cuda"):
    """Zeroed decode caches, one dict per layer: an ``attn`` layer's
    ``k``/``v`` [B, S, K, dh] in bf16, or int8 with float32 scales
    ``ks``/``vs`` [B, S, K]; an ``attn_chunked`` layer's ring of W = min(
    window, S) slots, ``k``/``v`` [B, W, K, dh] in bf16 and ``kpos`` [W]
    int32, all -1; an encoder-decoder's cross ``xk``/``xv`` [B,
    encoder_seq, K, dh] in bf16; a recurrent layer's float32 state
    (``models.recurrent``'s ``*_state``)."""
    dev = resolve_device(device)
    return [_block_cache(cfg, lt, batch, seq_len, dev) for lt in cfg.layer_types()]


def abstract_cache(cfg: ArchConfig, batch: int, seq_len: int):
    """:func:`init_cache`'s tree as ``meta`` tensors (the reference's
    ``jax.eval_shape(init_cache)``): same shapes and dtypes, nothing
    allocated.  ``meta`` is for counting only (the dry run); it does not go
    through ``resolve_device``, which keeps refusing it."""
    meta = torch.device("meta")
    return [_block_cache(cfg, lt, batch, seq_len, meta) for lt in cfg.layer_types()]


class Transformer(nn.Module):
    """The LM (any family of ``configs/``) over a parameter tree in the
    reference's layout (the tree :func:`param_specs` describes, as tensors
    on one device).

    The parameters are the reference's leaves, stacked ones included:
    ``params["layers"]["b0"]["wq"]`` is one [n_groups, d, H, dh] parameter,
    and each layer reads its slice of it inside :meth:`forward`, so a
    backward carries the gradients into the stacked leaves, the layout the
    reference differentiates and its optimizers update.  They are frozen
    (``requires_grad=False``) until ``requires_grad_()``, as
    ``training.train_step.init_train_state`` calls it; the serving paths
    (``forward(cache_len=)``, ``decode_step``, ``example_nll``) run under
    ``torch.no_grad()`` either way."""

    def __init__(self, cfg: ArchConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.weights = ParamTree(params)
        #: the parameters as the reference's dict tree (sorted keys)
        self.params = self.weights.tree()

    @property
    def layers(self) -> list:
        """Each layer's parameter tree, in layer order (slices of the
        stacked leaves, then the tail's)."""
        pat, n_groups, tail = _layer_layout(self.cfg)
        groups = ([_unstack(self.params["layers"][f"b{j}"], n_groups) for j in range(len(pat))]
                  if n_groups else [])
        return ([g[i] for i in range(n_groups) for g in groups]
                + [self.params["tail"][f"t{i}"] for i in range(len(tail))])

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    # ------------------------------------------------------------------ prefill

    def _qkv(self, p, h, pos):
        cfg = self.cfg
        q, k, v = proj(h, p["wq"]), proj(h, p["wk"]), proj(h, p["wv"])
        if cfg.qk_norm:  # the reference's qk-norm is rms_norm's arithmetic
            q, k = rms_norm(q, p["qn"]), rms_norm(k, p["kn"])
        if cfg.pos == "rope":
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        return q, k, v

    def _attn_train(self, p, x, ltype: str, cache_len: int, enc_out=None):
        cfg = self.cfg
        h = apply_norm(x, p["ln1"], cfg.norm)
        q, k, v = self._qkv(p, h, torch.arange(x.shape[1], device=x.device))
        mode, window = "causal", None
        if ltype == "attn_chunked":
            mode = "window" if cfg.family == "hybrid" else "chunk"
            window = _window(cfg)
        o = flash_attention(q, k, v, mode=mode, window=window, cap=cfg.logit_softcap)
        x = x + _out(o, p["wo"])
        if enc_out is not None:  # cross attention over the encoder's output
            hx = apply_norm(x, p["lnx"], cfg.norm)
            qx = proj(hx, p["xq"])
            kx, vx = proj(enc_out, p["xk"]), proj(enc_out, p["xv"])
            x = x + _out(flash_attention(qx, kx, vx, mode="full"), p["xo"])
        h2 = apply_norm(x, p["ln2"], cfg.norm)
        if cfg.num_experts:
            out, aux = moe_mlp(p["mlp"], h2, cfg, groups=cfg.moe_groups)
        else:
            out, aux = mlp(p["mlp"], h2, cfg), 0.0
        cache = None
        if cache_len:
            cache = self._kv_to_cache(ltype, k, v, cache_len)
            if enc_out is not None:
                cache["xk"], cache["xv"] = kx.to(torch.bfloat16), vx.to(torch.bfloat16)
        return x + out, cache, aux

    def _kv_to_cache(self, ltype: str, k, v, cache_len: int):
        """Pack full-sequence K/V [B,S,K,dh] into a decode cache of
        cache_len: an ``attn_chunked`` layer keeps the last min(W, S)
        positions, each in slot ``pos % W``."""
        B, S, K, dh = k.shape
        if ltype == "attn_chunked":
            W = min(_window(self.cfg), cache_len)
            take = min(W, S)
            kpos = torch.arange(S - take, S, dtype=torch.int32, device=k.device)
            slots = (kpos % W).long()
            cache = {"k": k.new_zeros((B, W, K, dh), dtype=torch.bfloat16),
                     "v": v.new_zeros((B, W, K, dh), dtype=torch.bfloat16),
                     "kpos": torch.full((W,), -1, dtype=torch.int32, device=k.device)}
            cache["k"][:, slots] = k[:, S - take:].to(torch.bfloat16)
            cache["v"][:, slots] = v[:, S - take:].to(torch.bfloat16)
            cache["kpos"][slots] = kpos
            return cache
        if S > cache_len:
            raise ValueError(f"prefill length {S} exceeds cache_len {cache_len}")
        pad = (0, 0, 0, 0, 0, cache_len - S)
        kf, vf = F.pad(k, pad), F.pad(v, pad)
        if self.cfg.kv_cache_dtype == "int8":
            kq, ks = _quant(kf)
            vq, vs = _quant(vf)
            return {"k": kq, "v": vq, "ks": ks, "vs": vs}
        return {"k": kf.to(torch.bfloat16), "v": vf.to(torch.bfloat16)}

    def _block_train(self, p, x, ltype: str, cache_len: int, enc_out=None):
        """-> (x, the block's cache or None, its aux loss)."""
        cfg = self.cfg
        if ltype in _ATTN:
            return self._attn_train(p, x, ltype, cache_len, enc_out)
        if ltype == "rglru":
            x, st = R.rglru_train(p, x, cfg)
            x = x + mlp(p["mlp"], apply_norm(x, p["ln2"], cfg.norm), cfg)
        elif ltype == "mlstm":
            x, st = R.mlstm_train(p, x, cfg)
        elif ltype == "slstm":
            x, st = R.slstm_train(p, x, cfg)
        else:
            raise ValueError(ltype)
        return x, (st if cache_len else None), 0.0

    def _group(self, x, aux, gp, enc_out=None, cache_len: int = 0):
        """One layer group (the reference's scanned ``group_fn``): each
        block of the pattern in turn -> (x, aux, the blocks' caches)."""
        caches = []
        for j, lt in enumerate(self.cfg.block_pattern):
            x, c, a = self._block_train(gp[f"b{j}"], x, lt, cache_len, enc_out)
            aux = aux + a
            caches.append(c)
        return x, aux, caches

    def _enc_block(self, x, pp):
        """One encoder layer: bidirectional attention (the reference's
        ``_qkv``: no RoPE, no qk-norm) and the MLP."""
        cfg = self.cfg
        h = apply_norm(x, pp["ln1"], cfg.norm)
        q, k, v = proj(h, pp["wq"]), proj(h, pp["wk"]), proj(h, pp["wv"])
        x = x + _out(flash_attention(q, k, v, mode="full"), pp["wo"])
        return x + mlp(pp["mlp"], apply_norm(x, pp["ln2"], cfg.norm), cfg)

    def _encoder_forward(self, frames):
        """The audio stub's frames [B, T, d] plus the encoder's positions,
        through its layers (each under the config's remat when a graph is
        built) and its final norm.  It runs in the dtype the frames and the
        weights promote to: the weights are cast to it, as ``jnp``'s
        promotion casts them in the reference's products."""
        cfg = self.cfg
        p = self.params["encoder"]
        x = frames + p["pos"][None, :frames.shape[1]]
        blk = self._enc_block
        if torch.is_grad_enabled() and any(t.requires_grad for t in self.parameters()):
            blk = _remat_wrap(blk, cfg.remat)
        for pp in _unstack(p["layers"]["b0"], cfg.encoder_layers):
            x = blk(x, tree_map(lambda t: t.to(x.dtype), pp))
        return apply_norm(x, p["ln_f"], cfg.norm)

    def forward(self, batch: Dict[str, torch.Tensor], cache_len: int = 0):
        """Full-sequence forward -> (final hidden states [B, S, d], aux,
        caches).  With ``cache_len`` > 0 this is the prefill (under
        ``torch.no_grad()``): per-layer decode caches with the K/V packed
        (or quantized) into ``cache_len`` slots, in :func:`init_cache`'s
        layout; else ``None``.  When it builds a graph, each layer group
        runs under the config's ``remat`` policy (:func:`_remat_wrap`)."""
        if cache_len:
            with torch.no_grad():
                return self._forward(batch, cache_len)
        return self._forward(batch, 0)

    def _forward(self, batch, cache_len: int):
        cfg = self.cfg
        pat, n_groups, tail = _layer_layout(cfg)
        # F.embedding, not indexing: the backward of ``embed[tokens]``
        # (index_put_ with accumulate) is not deterministic on the CPU, and
        # a resumed run must be bitwise an uninterrupted one
        x = F.embedding(batch["tokens"].long(), self.params["embed"])
        if cfg.frontend == "vision_stub" and "patches" in batch:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        enc_out = self._encoder_forward(batch["frames"]) if cfg.is_encoder_decoder else None
        if cfg.pos == "learned":
            x = x + self.params["pos_embed"][None, :x.shape[1]]
        group = functools.partial(self._group, cache_len=cache_len)
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
            group = _remat_wrap(group, cfg.remat)
        stacks = ([_unstack(self.params["layers"][f"b{j}"], n_groups) for j in range(len(pat))]
                  if n_groups else [])
        # aux in float32, summed over the groups' blocks and then the tail's,
        # in the reference's order
        aux = torch.zeros((), dtype=_F32, device=x.device)
        caches = []
        for i in range(n_groups):
            x, aux, cs = group(x, aux, {f"b{j}": stacks[j][i] for j in range(len(pat))}, enc_out)
            caches += cs
        for i, lt in enumerate(tail):
            x, c, a = self._block_train(self.params["tail"][f"t{i}"], x, lt, cache_len, enc_out)
            aux = aux + a
            caches.append(c)
        x = apply_norm(x, self.params["ln_f"], cfg.norm)
        return x, aux, (caches if cache_len else None)

    def head(self):
        """The unembedding [d, V_padded]: ``embed.T`` when tied."""
        return self.params["embed"].T if self.cfg.tie_embeddings else self.params["lm_head"]

    def unembed(self, x):
        return x @ self.head()

    # ------------------------------------------------------------------ decode

    def init_cache(self, batch: int, seq_len: int):
        return init_cache(self.cfg, batch, seq_len, self.device)

    def _attn_decode(self, p, x1, cache, pos: int, ltype: str):
        """x1 [B, d]; writes the token's K/V at ``pos`` (an ``attn_chunked``
        layer: at slot ``pos % W``, with ``kpos``) in place; an
        encoder-decoder attends the cached ``xk``/``xv`` at every slot."""
        cfg = self.cfg
        h = apply_norm(x1, p["ln1"], cfg.norm)
        q, k1, v1 = self._qkv(p, h, pos)
        if ltype == "attn_chunked":
            W = cache["k"].shape[1]
            slot = pos % W
            cache["k"][:, slot] = k1.to(cache["k"].dtype)
            cache["v"][:, slot] = v1.to(cache["v"].dtype)
            cache["kpos"][slot] = pos
            kp = cache["kpos"]
            if cfg.family == "hybrid":  # sliding window
                valid = (kp >= 0) & (kp > pos - W) & (kp <= pos)
            else:  # llama4's chunks: the keys of the query's own chunk
                Wc = cfg.attn_chunk
                valid = (kp >= 0) & (kp // Wc == pos // Wc) & (kp <= pos)
            kc, vc = cache["k"], cache["v"]
        elif cfg.kv_cache_dtype == "int8":
            S = cache["k"].shape[1]
            kq, ks = _quant(k1)
            vq, vs = _quant(v1)
            cache["k"][:, pos] = kq
            cache["v"][:, pos] = vq
            cache["ks"][:, pos] = ks
            cache["vs"][:, pos] = vs
            kc = _dequant(cache["k"], cache["ks"], q.dtype)
            vc = _dequant(cache["v"], cache["vs"], q.dtype)
            valid = torch.arange(S, device=x1.device) <= pos
        else:
            S = cache["k"].shape[1]
            cache["k"][:, pos] = k1.to(cache["k"].dtype)
            cache["v"][:, pos] = v1.to(cache["v"].dtype)
            kc, vc = cache["k"], cache["v"]
            valid = torch.arange(S, device=x1.device) <= pos
        o = decode_attention(q, kc, vc, valid, cap=cfg.logit_softcap)
        x1 = x1 + _out(o, p["wo"])
        if cfg.is_encoder_decoder:  # cross attention over the cached encoder K/V
            qx = proj(apply_norm(x1, p["lnx"], cfg.norm), p["xq"])
            every = torch.ones(cache["xk"].shape[1], dtype=torch.bool, device=x1.device)
            x1 = x1 + _out(decode_attention(qx, cache["xk"], cache["xv"], every), p["xo"])
        h2 = apply_norm(x1, p["ln2"], cfg.norm)
        if cfg.num_experts:
            return x1 + moe_mlp(p["mlp"], h2[:, None, :], cfg, groups=cfg.moe_groups)[0][:, 0]
        return x1 + mlp(p["mlp"], h2, cfg)

    def _block_decode(self, p, x1, cache, pos: int, ltype: str):
        """-> x1 after the block; the block's cache updated in place (a
        recurrent layer's state dict gets its new entries)."""
        cfg = self.cfg
        if ltype in _ATTN:
            return self._attn_decode(p, x1, cache, pos, ltype)
        if ltype == "rglru":
            x1, st = R.rglru_decode(p, x1, cache, cfg)
            x1 = x1 + mlp(p["mlp"], apply_norm(x1, p["ln2"], cfg.norm), cfg)
        elif ltype == "mlstm":
            x1, st = R.mlstm_decode(p, x1, cache, cfg)
        elif ltype == "slstm":
            x1, st = R.slstm_decode(p, x1, cache, cfg)
        else:
            raise ValueError(ltype)
        cache.update(st)
        return x1

    @torch.no_grad()
    def decode_step(self, token, cache, pos):
        """One decoding step: token [B] ids, ``pos`` the position (an int).
        Returns (logits [B, V_padded] float32, the cache updated in place)."""
        pos = int(pos)  # torch-contracts: allow(C003)
        x1 = F.embedding(token.long(), self.params["embed"])
        if self.cfg.pos == "learned":
            x1 = x1 + self.params["pos_embed"][pos]
        for p, c, lt in zip(self.layers, cache, self.cfg.layer_types()):
            x1 = self._block_decode(p, x1, c, pos, lt)
        x1 = apply_norm(x1, self.params["ln_f"], self.cfg.norm)
        return self.unembed(x1).to(_F32), cache

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def example_nll(self, tokens, *, block: int = 512, rows: int = 4096):
        """Mean next-token negative log-likelihood of each example
        ([n, S] tokens -> [n] float32): the reference's
        ``examples/online_eval.py`` ``loss_per_example``.

        Bounded memory: the forward runs over ``block`` examples at a time
        and the float32 logits of at most ``rows`` positions exist at once
        (all n examples' logits at a real vocabulary would not fit).  An
        MoE model is refused (:func:`check_per_example`)."""
        check_per_example(self.cfg)
        n, S = tokens.shape
        head = self.head()
        out = torch.empty(n, dtype=_F32, device=self.device)
        for i in range(0, n, block):
            tt = tokens[i:i + block].long()
            x, _, _ = self.forward({"tokens": tt})
            xs = x[:, :-1].reshape(-1, x.shape[-1])
            tgt = tt[:, 1:].reshape(-1, 1)
            nll = torch.empty(xs.shape[0], dtype=_F32, device=self.device)
            for j in range(0, xs.shape[0], rows):
                logits = (xs[j:j + rows] @ head).to(_F32)
                nll[j:j + rows] = (torch.logsumexp(logits, dim=-1)
                                   - logits.gather(-1, tgt[j:j + rows])[:, 0])
            out[i:i + tt.shape[0]] = nll.reshape(tt.shape[0], S - 1).mean(dim=1)
        return out


def xent_loss(model: Transformer, cfg: ArchConfig, x, targets, mask, seq_chunk: int = 1024):
    """Chunked softmax cross-entropy (the reference's ``xent_loss``): the
    masked negative log-likelihood summed in float32 (float64 for a float64
    model) over sequence chunks of
    ``seq_chunk`` (lowered until it divides S), over the mask's sum.

    x [B, S, d]; targets and mask [B, S].  One chunk's float32 logits [B, c,
    V] exist at a time: under autograd each chunk is recomputed in the
    backward, so the graph keeps only x, never [B, S, V]."""
    B, S, _ = x.shape
    head = model.head()
    c = min(seq_chunk, S)
    while S % c:
        c -= 1

    def chunk_loss(xc, tc, mc, head):
        logits = xc @ head
        logits = logits.to(acc_dtype(logits))
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, tc.long()[..., None])[..., 0]
        return torch.sum((lse - gold) * mc)

    remat = torch.is_grad_enabled() and (x.requires_grad or head.requires_grad)
    total = torch.zeros((), dtype=acc_dtype(x), device=x.device)
    for i in range(S // c):
        args = (x[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c],
                mask[:, i * c:(i + 1) * c], head)
        total = total + (checkpoint(chunk_loss, *args, use_reentrant=False) if remat
                         else chunk_loss(*args))
    return total / torch.clamp(torch.sum(mask), min=1.0)


def init_model(cfg: ArchConfig, *, seed: int = 0, dtype=torch.bfloat16,
               device="cuda") -> Transformer:
    """A model with random weights from ``seed``: :func:`param_specs` drawn
    by ``spec.init_params`` on a generator on ``device`` (no CPU fallback:
    a CUDA device without a card raises)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, init_params(param_specs(cfg, dtype), gen, dev))
