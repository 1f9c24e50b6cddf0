"""Transformer substrate layers: norms, RoPE, attention, MLP.

Port of ``repro/models/layers.py``, in plain PyTorch as the reference is
plain ``jnp``: no library attention kernel.  Rounding follows the
reference where it decides the result:

* the norms normalize in float32, cast back to ``x``'s dtype, and only then
  multiply by ``gamma``;
* every step the reference takes in float32 (norms, RoPE angles, attention
  products) runs in float32 or wider (:func:`acc_dtype`): float64 on float64
  inputs, so that a float64 model is float64 throughout and measures how
  far float32 rounding moves a result;
* RoPE rotates the two halves of the head vector (not interleaved pairs),
  with angles in float32;
* masked scores are ``NEG_INF = -1e30``, not ``-inf``, so a fully masked
  row averages its values uniformly, as the reference's does;
* the attention products accumulate in float32 (the reference's
  ``preferred_element_type``): the operands are upcast first, since a
  bf16 ``einsum`` on the card rounds its output to bf16; probabilities are
  rounded to the values' dtype before the second product, as there.

``flash_attention`` keeps the reference's query blocks and the static
key-block range each block can see (triangle scheduling: no work on a fully
masked block); within a block it takes one masked softmax over that range,
where the reference runs an online softmax over its key blocks — the same
function, summed in another order.  Under autograd each query block is
recomputed in the backward (``torch.utils.checkpoint``), as the reference
rematerializes each key-block step: remat changes memory, not values.

Mask modes:
  causal  — standard autoregressive
  chunk   — attend only within the surrounding `window`-sized chunk
            (Llama-4 style chunked local attention), causal inside
  window  — sliding window of `window` past positions (RG local attention)
  full    — bidirectional (encoder / cross attention)
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
_F32 = torch.float32


def acc_dtype(x) -> torch.dtype:
    """float32, or ``x``'s dtype where that is wider (float64)."""
    return torch.promote_types(x.dtype, _F32)


# --------------------------------------------------------------------------- norms

def rms_norm(x, gamma, eps=1e-6):
    x32 = x.to(acc_dtype(x))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(x, gamma, beta, eps=1e-5):
    x32 = x.to(acc_dtype(x))
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * gamma + beta


def apply_norm(x, p, kind):
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def proj(h, w):
    """``h [..., d] @ w [d, a, b] -> [..., a, b]`` (the reference's
    ``einsum("bsd,dhe->bshe")`` and its one-token form) as one matmul, in
    the dtype the two promote to (``jnp``'s rule: float32 with bf16 gives
    float32)."""
    dt = torch.promote_types(h.dtype, w.dtype)
    return (h.to(dt) @ w.reshape(w.shape[0], -1).to(dt)).reshape(*h.shape[:-1], *w.shape[1:])


# --------------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float, device=None, dtype=_F32):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=dtype, device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x [B,S,H,dh] with positions [S], or [B,H,dh] with a scalar position."""
    dh = x.shape[-1]
    acc = acc_dtype(x)
    freqs = rope_freqs(dh, theta, x.device, acc)           # [dh/2]
    pos = torch.as_tensor(positions, dtype=acc, device=x.device)
    ang = pos[..., None] * freqs                           # [S, dh/2] | [dh/2]
    if x.ndim == 4:                                        # [B,S,H,dh]
        ang = ang.reshape((1,) + tuple(ang.shape[:-1]) + (1, dh // 2))
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1f, x2f = x[..., : dh // 2].to(acc), x[..., dh // 2:].to(acc)
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def softcap(scores, cap: Optional[float]):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


# --------------------------------------------------------------------------- attention

def _kv_block_range(i, n_kv, qb, kvb, mode, window):
    """Static kv-block range [lo, hi) visible to query block i."""
    if mode == "full":
        return 0, n_kv
    hi = min(n_kv, -(-((i + 1) * qb) // kvb))  # causal upper bound
    if mode == "causal":
        return 0, hi
    if mode == "window":
        lo = max(0, (i * qb - window) // kvb)
        return lo, hi
    if mode == "chunk":
        lo = ((i * qb) // window) * (window // kvb)
        return lo, hi
    raise ValueError(mode)


def flash_attention(q, k, v, *, mode="causal", window=None, cap=None,
                    q_block=1024, kv_block=1024):
    """q [B,Sq,H,dh], k/v [B,Sk,K,dh] -> [B,Sq,H,dh].

    Query positions are aligned with key positions (q_offset=0); the decode
    path (one new token against a cache) is :func:`decode_attention`.
    """
    B, Sq, H, dh = q.shape
    _, Sk, K, _ = k.shape
    G = H // K

    def pick(S, target):
        b = min(target, S)
        while S % b:
            b -= 1
        return b

    if mode in ("window", "chunk") and window is not None and window >= Sk:
        mode = "causal"      # the window covers the whole sequence
    if mode in ("window", "chunk"):
        if window is None:
            raise ValueError(f"mode {mode!r} needs a window")
        qb = pick(Sq, min(q_block, window))
        kvb = pick(Sk, min(kv_block, window))
        if window % kvb:
            raise ValueError(f"window {window} must be a multiple of kv block {kvb}")
    else:
        qb = pick(Sq, q_block)
        kvb = pick(Sk, kv_block)
    n_q, n_kv = Sq // qb, Sk // kvb
    scale = 1.0 / math.sqrt(dh)
    vdt = v.dtype
    acc = acc_dtype(q)

    def block(i, lo, hi, qi, kj, vj):
        qi = qi.reshape(B, qb, K, G, dh).to(acc)
        s = torch.einsum("bqkgd,btkd->bqkgt", qi, kj.to(acc)) * scale
        s = softcap(s, cap)
        if mode != "full":
            qpos = i * qb + torch.arange(qb, device=q.device)
            kpos = torch.arange(lo * kvb, hi * kvb, device=q.device)
            msk = kpos[None, :] <= qpos[:, None]                       # causal
            if mode == "window":
                msk &= kpos[None, :] > (qpos[:, None] - window)
            elif mode == "chunk":
                msk &= (kpos[None, :] // window) == (qpos[:, None] // window)
            s = torch.where(msk[None, :, None, None, :], s, NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m)
        den = torch.sum(p, dim=-1)
        o = torch.einsum("bqkgt,btkd->bqkgd", p.to(vdt).to(acc), vj.to(acc))
        o = o / torch.clamp(den, min=1e-30)[..., None]
        return o.reshape(B, qb, H, dh)

    # under autograd each query block is rematerialized (the reference
    # checkpoints each key-block step): only its q/k/v slices are saved,
    # never its float32 [B, qb, K, G, Sk] scores
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    outs = []
    for i in range(n_q):
        lo, hi = _kv_block_range(i, n_kv, qb, kvb, mode, window)
        args = (i, lo, hi, q[:, i * qb:(i + 1) * qb], k[:, lo * kvb:hi * kvb],
                v[:, lo * kvb:hi * kvb])
        outs.append(checkpoint(block, *args, use_reentrant=False) if remat else block(*args))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid, *, cap=None):
    """One-token attention against a cache.

    q [B,H,dh]; k/v_cache [B,S,K,dh] (any float dtype); valid [B,S] or [S]
    bool.  The cache is cast to the query's dtype, as in the reference, and
    the products accumulate in float32."""
    B, H, dh = q.shape
    K = k_cache.shape[2]
    G = H // K
    acc = acc_dtype(q)
    qh = q.reshape(B, K, G, dh).to(acc)
    kc = k_cache.to(q.dtype).to(acc)
    s = torch.einsum("bkgd,btkd->bkgt", qh, kc)
    s = s / math.sqrt(dh)
    s = softcap(s, cap)
    if valid.ndim == 1:
        valid = valid[None, :]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vc = v_cache.to(q.dtype).to(acc)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(q.dtype).to(acc), vc)
    return o.reshape(B, H, dh).to(q.dtype)


# --------------------------------------------------------------------------- mlp

class _Logistic(torch.autograd.Function):
    """``lax.logistic``: forward ``1 / (1 + exp(-x))`` one primitive at a
    time in ``x``'s dtype; backward the primitive's own rule ``g * (y * (1 -
    y))``.  Autograd through the forward's primitives would make ``0 * inf``
    (NaN) wherever ``exp(-x)`` overflows, below about -88."""

    @staticmethod
    def forward(ctx, x):
        one = torch.ones((), dtype=x.dtype, device=x.device)
        y = one / (one + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def mlp_act(x, kind: str):
    """The reference's activations, one primitive at a time in ``x``'s
    dtype: ``jax.nn.silu`` is ``x * logistic(x)`` with ``logistic`` lowered
    as ``1 / (1 + exp(-x))``, and ``jax.nn.gelu`` is the tanh
    approximation; in bf16 each step rounds, which fused library versions
    (``F.silu``, ``F.gelu``) do not, so they differ in most bf16 entries."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    if kind == "silu":
        return x * _Logistic.apply(x)
    if kind == "gelu":
        c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
        k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
        cdf = 0.5 * (one + torch.tanh(c * (x + k * (x * x * x))))
        return x * cdf.to(x.dtype)
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def mlp(p, x, cfg):
    """Gated (SwiGLU-style) or plain MLP."""
    if cfg.mlp_gated:
        h = mlp_act(x @ p["wi"], cfg.mlp_act) * (x @ p["wg"])
    else:
        h = mlp_act(x @ p["wi"], cfg.mlp_act)
    return h @ p["wo"]
