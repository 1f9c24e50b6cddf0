"""Recurrent temporal-mixing blocks: RG-LRU (Griffin/RecurrentGemma), mLSTM
and sLSTM (xLSTM).

Port of ``repro/models/recurrent.py``.  Each block exposes:

  *_specs(cfg, dtype)               — ParamSpec tree
  *_train(p, x, cfg)                — full-sequence forward -> (x, final state)
  *_decode(p, x1, state, cfg)       — one-token step -> (x1, new state)
  *_state(cfg, batch, device)       — zero state

Cell states are float32 whatever the activations' dtype (float64 in a
float64 model: the cells compute in ``layers.acc_dtype``).

Train-time forms:
  * RG-LRU is a linear diagonal recurrence h_t = a_t h_{t-1} + b_t; the
    reference runs ``lax.associative_scan``, the port a log-depth doubling
    scan (Hillis–Steele) over the sequence with the reference's combine
    ``(a1·a2, a2·b1 + b2)``: ⌈log2 S⌉ steps, each elementwise over the whole
    sequence.  The association order differs from XLA's, so the two agree
    to float32 rounding, not bitwise.
  * mLSTM's default form is chunkwise-parallel (``models.mlstm_chunked``);
    ``mlstm_form="sequential"`` runs the cell step by step.
  * sLSTM is sequential by design (the recurrent weights sit inside the
    nonlinearity).  The port projects the four gate inputs of the whole
    sequence in one matmul and applies the four recurrent matrices, stacked
    and cast to float32, in one batched product a step.

The sequential loops run in blocks of ``block`` steps (the reference's
``_blocked_scan``): when a graph is built each block runs under
``torch.utils.checkpoint``, so the backward keeps the carries only at block
boundaries.  That changes memory, not values.

The conv state a prefill leaves is the last ``taps - 1`` rows of the
*pre-conv* input in float32, as the reference keeps them.  After a prompt
shorter than that the reference keeps fewer rows (``u_in[:, -3:]``), and its
next decode step fails; the port pads the missing rows with zeros at the
front, which is the zero initial state, so decoding on from such a prefill
equals decoding every token from :func:`rglru_state`/:func:`mlstm_state`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.cost import fill_trips, trips
from repro_torch.models.layers import acc_dtype, apply_norm, mlp_act, proj
from repro_torch.models.spec import ParamSpec

_F32 = torch.float32
#: the depthwise conv's taps (the reference's ``conv`` leaves are [4, w])
TAPS = 4


def norm_spec(d, kind, dtype):
    if kind == "rms":
        return {"scale": ParamSpec((d,), ("embed",), "ones", dtype=dtype)}
    return {"scale": ParamSpec((d,), ("embed",), "ones", dtype=dtype),
            "bias": ParamSpec((d,), ("embed",), "zeros", dtype=dtype)}


def _graph(*ts) -> bool:
    """True when autograd records: grad mode on and some tensor needs grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _blocked_scan(step, carry, xs, block: int, consts=()):
    """Time scan in blocks: ``step(consts, carry, x_t) -> (carry, y_t)`` over
    time-major ``xs`` (a tuple of [S, ...] tensors) -> (final carry, ys
    [S, ...]).  ``block`` shrinks to a divisor of S; when a graph is built
    each block runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` around its inner scan).  The blocks are a loop of
    identical trips for ``repro_torch.cost``'s loop-scaled count."""
    S = xs[0].shape[0]
    b = min(block, S)
    while S % b:
        b -= 1
    nc, nk = len(carry), len(consts)

    def run(*flat):
        k, c, xb = flat[:nk], tuple(flat[nk:nk + nc]), flat[nk + nc:]
        ys = []
        for t in range(xb[0].shape[0]):
            c, y = step(k, c, tuple(x[t] for x in xb))
            ys.append(y)
        return (*c, torch.stack(ys))

    remat = _graph(*carry, *xs, *consts)
    outs = []
    for j in trips(S // b):
        i = j * b
        args = (*consts, *carry, *(x[i:i + b] for x in xs))
        res = checkpoint(run, *args, use_reentrant=False) if remat else run(*args)
        carry, ys = tuple(res[:-1]), res[-1]
        outs.append(ys)
    return carry, torch.cat(fill_trips(outs, S // b))


def _causal_conv(u, kernel):
    """Depthwise causal conv, u [B,S,w], kernel [taps,w], in u's dtype:
    ``kernel[j]`` multiplies ``u[t-j]``, the taps summed in the reference's
    order."""
    taps, S = kernel.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, taps - 1, 0))
    out = pad[:, 0:S] * kernel[taps - 1]
    for t in range(1, taps):
        out = out + pad[:, t:t + S] * kernel[taps - 1 - t]
    return out


def _conv_step(x1, conv_state, kernel):
    """x1 [B,w]; conv_state [B,taps-1,w] (most recent last) -> (out [B,w],
    the new state).  The window (oldest..newest) contracts against the
    reversed kernel, as ``_causal_conv`` does."""
    window = torch.cat([conv_state, x1[:, None]], dim=1)  # [B,taps,w]
    out = torch.sum(window * kernel.flip(0), dim=1)
    return out, window[:, 1:]


def _conv_tail(u_in):
    """The conv state a prefill leaves: the last taps-1 rows of the pre-conv
    input u_in [B,S,w] in float32, zero rows in front when S < taps-1."""
    tail = u_in[:, -(TAPS - 1):].to(acc_dtype(u_in))
    short = TAPS - 1 - tail.shape[1]
    return F.pad(tail, (0, 0, short, 0)) if short else tail


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches to
    the identity above 20 and rounds differently below)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# =========================================================================== RG-LRU

def rglru_specs(cfg, dtype):
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "ln1": norm_spec(d, cfg.norm, dtype),
        "w_gate": ParamSpec((d, w), ("embed", "state"), dtype=dtype),
        "w_rec": ParamSpec((d, w), ("embed", "state"), dtype=dtype),
        "conv": ParamSpec((TAPS, w), (None, "state"), scale=0.5, dtype=dtype),
        "ga_w": ParamSpec((w,), ("state",), "zeros", dtype=dtype),
        "ga_b": ParamSpec((w,), ("state",), "zeros", dtype=dtype),
        "gx_w": ParamSpec((w,), ("state",), "zeros", dtype=dtype),
        "gx_b": ParamSpec((w,), ("state",), "zeros", dtype=dtype),
        "lam": ParamSpec((w,), ("state",), "ones", dtype=_F32),
        "w_out": ParamSpec((w, d), ("state", "embed"), dtype=dtype),
    }


_LRU_C = 8.0


def _rglru_gates(p, u):
    """u [.., w] conv output -> (a, gated input b), both float32."""
    cd = acc_dtype(u)
    uf = u.to(cd)
    r = torch.sigmoid(uf * p["ga_w"].to(cd) + p["ga_b"].to(cd))
    i = torch.sigmoid(uf * p["gx_w"].to(cd) + p["gx_b"].to(cd))
    log_a = -_LRU_C * r * _softplus(p["lam"].to(cd))
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, b


def linear_scan(a, b):
    """h_t = a_t·h_{t-1} + b_t along dim 1 from h_{-1} = 0, as a log-depth
    doubling scan: at distance d = 1, 2, 4, ... each position folds in the
    one d before it with the reference's combine ``(a1·a2, a2·b1 + b2)``."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_train(p, x, cfg):
    h = apply_norm(x, p["ln1"], cfg.norm)
    g = mlp_act(h @ p["w_gate"], "gelu")
    u_in = h @ p["w_rec"]
    u = _causal_conv(u_in, p["conv"])
    a, b = _rglru_gates(p, u)
    hseq = linear_scan(a, b)
    out = (g * hseq.to(x.dtype)) @ p["w_out"]
    return x + out, {"h": hseq[:, -1], "conv": _conv_tail(u_in)}


def rglru_state(cfg, batch, device):
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=_F32, device=device),
            "conv": torch.zeros((batch, TAPS - 1, w), dtype=_F32, device=device)}


def rglru_decode(p, x1, state, cfg):
    """x1 [B, d] one token."""
    h = apply_norm(x1, p["ln1"], cfg.norm)
    g = mlp_act(h @ p["w_gate"], "gelu")
    cd = acc_dtype(x1)
    u_in = (h @ p["w_rec"]).to(cd)
    u, conv_new = _conv_step(u_in, state["conv"], p["conv"].to(cd))
    a, b = _rglru_gates(p, u)
    h_new = a * state["h"] + b
    out = (g * h_new.to(x1.dtype)) @ p["w_out"]
    return x1 + out, {"h": h_new, "conv": conv_new}


# =========================================================================== mLSTM

def _mlstm_dims(cfg):
    d = cfg.d_model
    di = 2 * d
    H = cfg.num_heads
    return d, di, H, di // H


def mlstm_specs(cfg, dtype):
    d, di, H, dh = _mlstm_dims(cfg)
    return {
        "ln1": norm_spec(d, cfg.norm, dtype),
        "w_up": ParamSpec((d, di), ("embed", "state"), dtype=dtype),
        "w_z": ParamSpec((d, di), ("embed", "state"), dtype=dtype),
        "conv": ParamSpec((TAPS, di), (None, "state"), scale=0.5, dtype=dtype),
        "wq": ParamSpec((di, H, dh), ("state", "heads", None), dtype=dtype),
        "wk": ParamSpec((di, H, dh), ("state", "heads", None), dtype=dtype),
        "wv": ParamSpec((di, H, dh), ("state", "heads", None), dtype=dtype),
        "w_if": ParamSpec((di, 2 * H), ("state", None), scale=0.1, dtype=dtype),
        "b_if": ParamSpec((2 * H,), (None,), "zeros", dtype=_F32),
        "w_down": ParamSpec((di, d), ("state", "embed"), dtype=dtype),
    }


def _mlstm_cell_step(C, n, m, q, k, v, logi, logf):
    """One stabilized mLSTM step.  C [B,H,dh,dh]; n, q, k, v [B,H,dh];
    m, logi, logf [B,H]."""
    m_new = torch.maximum(logf + m, logi)
    i_p = torch.exp(logi - m_new)
    f_p = torch.exp(logf + m - m_new)
    C_new = f_p[..., None, None] * C + i_p[..., None, None] * (v[..., :, None] * k[..., None, :])
    n_new = f_p[..., None] * n + i_p[..., None] * k
    num = (C_new @ q[..., None])[..., 0]
    den = torch.clamp(torch.abs(torch.sum(n_new * q, dim=-1)), min=1.0)
    return C_new, n_new, m_new, num / den[..., None]


def _mlstm_qkv(p, u):
    """u [.., di] conv output -> q, k, v [.., H, dh], logi, logf [.., H] in
    float32; k scaled by 1/sqrt(dh) after the cast."""
    cd = acc_dtype(u)
    q = proj(u, p["wq"]).to(cd)
    k = proj(u, p["wk"]).to(cd)
    v = proj(u, p["wv"]).to(cd)
    k = k / math.sqrt(q.shape[-1])
    gates = (u @ p["w_if"]).to(cd) + p["b_if"]
    H = q.shape[-2]
    return q, k, v, gates[..., :H], F.logsigmoid(gates[..., H:])


def _mlstm_scan_step(_, carry, xs):
    C, n, m, h = _mlstm_cell_step(*carry, *xs)
    return (C, n, m), h


def mlstm_sequential(q, k, v, logi, logf, initial=None, block: int = 128):
    """The cell step by step over [B,S,H,...] inputs (blocks of ``block``
    steps) -> (h [B,S,H,dh], (C, n, m) final)."""
    B, S, H, dh = q.shape
    if initial is None:
        initial = (q.new_zeros((B, H, dh, dh)), q.new_zeros((B, H, dh)), q.new_zeros((B, H)))
    xs = tuple(t.transpose(0, 1) for t in (q, k, v, logi, logf))
    final, hs = _blocked_scan(_mlstm_scan_step, tuple(initial), xs, block)
    return hs.transpose(0, 1), final


def mlstm_train(p, x, cfg):
    from repro_torch.models.mlstm_chunked import mlstm_chunkwise

    d, di, H, dh = _mlstm_dims(cfg)
    B, S, _ = x.shape
    hin = apply_norm(x, p["ln1"], cfg.norm)
    z = hin @ p["w_z"]
    u_in = hin @ p["w_up"]
    u = _causal_conv(u_in, p["conv"])
    q, k, v, logi, logf = _mlstm_qkv(p, u)
    if cfg.mlstm_form == "chunkwise":
        hseq, (Cf, nf, mf) = mlstm_chunkwise(q, k, v, logi, logf, chunk=128)
    else:
        hseq, (Cf, nf, mf) = mlstm_sequential(q, k, v, logi, logf, block=128)
    hs = hseq.reshape(B, S, di)
    out = (hs.to(x.dtype) * mlp_act(z, "silu")) @ p["w_down"]
    return x + out, {"C": Cf, "n": nf, "m": mf, "conv": _conv_tail(u_in)}


def mlstm_state(cfg, batch, device):
    d, di, H, dh = _mlstm_dims(cfg)
    return {"C": torch.zeros((batch, H, dh, dh), dtype=_F32, device=device),
            "n": torch.zeros((batch, H, dh), dtype=_F32, device=device),
            "m": torch.zeros((batch, H), dtype=_F32, device=device),
            "conv": torch.zeros((batch, TAPS - 1, di), dtype=_F32, device=device)}


def mlstm_decode(p, x1, state, cfg):
    hin = apply_norm(x1, p["ln1"], cfg.norm)
    z = hin @ p["w_z"]
    cd = acc_dtype(x1)
    u_in = (hin @ p["w_up"]).to(cd)
    u, conv_new = _conv_step(u_in, state["conv"], p["conv"].to(cd))
    q, k, v, logi, logf = _mlstm_qkv(p, u.to(x1.dtype))
    C, n, m, h = _mlstm_cell_step(state["C"], state["n"], state["m"], q, k, v, logi, logf)
    hf = h.reshape(x1.shape[0], u.shape[-1])
    out = (hf.to(x1.dtype) * mlp_act(z, "silu")) @ p["w_down"]
    return x1 + out, {"C": C, "n": n, "m": m, "conv": conv_new}


# =========================================================================== sLSTM

def _slstm_dims(cfg):
    d = cfg.d_model
    H = cfg.num_heads
    fd = -(-int(d * 8 / 3) // 64) * 64
    return d, H, d // H, fd


def slstm_specs(cfg, dtype):
    d, H, dh, fd = _slstm_dims(cfg)

    def gate():
        return ParamSpec((d, H, dh), ("embed", "heads", None), scale=0.5, dtype=dtype)

    def rec():
        return ParamSpec((H, dh, dh), ("heads", None, None), scale=0.5, dtype=dtype)

    def bias():
        return ParamSpec((H, dh), ("heads", None), "zeros", dtype=_F32)

    return {
        "ln1": norm_spec(d, cfg.norm, dtype),
        "wz": gate(), "wi": gate(), "wf": gate(), "wo": gate(),
        "rz": rec(), "ri": rec(), "rf": rec(), "ro": rec(),
        "bz": bias(), "bi": bias(), "bf": bias(), "bo": bias(),
        "ln2": norm_spec(d, cfg.norm, dtype),
        "ffn_wi": ParamSpec((d, 2 * fd), ("embed", "mlp"), dtype=dtype),
        "ffn_wo": ParamSpec((fd, d), ("mlp", "embed"), dtype=dtype),
    }


_GATES = ("z", "i", "f", "o")


def _slstm_stacked(p, cd):
    """The four gates' weights as one operand each: the input projections
    [d, 4·H·dh] (gate-major), the recurrent matrices in the cells' dtype
    ``cd`` [H, dh, 4·dh] and the biases [4, H, dh]."""
    W = torch.stack([p["w" + g] for g in _GATES], dim=1)  # [d, 4, H, dh]
    R = torch.cat([p["r" + g].to(cd) for g in _GATES], dim=-1)
    b = torch.stack([p["b" + g] for g in _GATES])
    return W.reshape(W.shape[0], -1), R, b


def _slstm_step(consts, carry, xs):
    """One step.  xs = (x_pre [B,4,H,dh], the gate inputs' projections in
    float32); carry = (c, n, m, h) [B,H,dh] float32."""
    R, b = consts
    (x_pre,) = xs
    c, n, m, h = carry
    B, _, H, dh = x_pre.shape
    rec = torch.bmm(h.transpose(0, 1), R).view(H, B, 4, dh).permute(1, 2, 0, 3)
    pre = x_pre + rec + b
    z = torch.tanh(pre[:, 0])
    logi = pre[:, 1]
    logf = F.logsigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(logf + m, logi)
    i_p = torch.exp(logi - m_new)
    f_p = torch.exp(logf + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = torch.clamp(f_p * n + i_p, min=1e-6)
    h_new = o * c_new / n_new
    return (c_new, n_new, m_new, h_new), h_new


def _slstm_ffn(p, x, cfg):
    """The gated FFN after the cell (xLSTM's post-up-projection block)."""
    hf = apply_norm(x, p["ln2"], cfg.norm)
    a, b = torch.chunk(hf @ p["ffn_wi"], 2, dim=-1)
    return x + (mlp_act(a, "gelu") * b) @ p["ffn_wo"]


def slstm_train(p, x, cfg):
    d, H, dh, fd = _slstm_dims(cfg)
    B, S, _ = x.shape
    hin = apply_norm(x, p["ln1"], cfg.norm)
    cd = acc_dtype(x)
    W, R, b = _slstm_stacked(p, cd)
    x_pre = (hin @ W).to(cd).view(B, S, 4, H, dh)
    z0 = torch.zeros((B, H, dh), dtype=cd, device=x.device)
    (cf, nf, mf, hfin), hs = _blocked_scan(_slstm_step, (z0, z0, z0, z0),
                                           (x_pre.transpose(0, 1),), 128, consts=(R, b))
    x = x + hs.transpose(0, 1).reshape(B, S, d).to(x.dtype)
    return _slstm_ffn(p, x, cfg), {"c": cf, "n": nf, "m": mf, "h": hfin}


def slstm_state(cfg, batch, device):
    d, H, dh, fd = _slstm_dims(cfg)
    return {k: torch.zeros((batch, H, dh), dtype=_F32, device=device) for k in "cnmh"}


def slstm_decode(p, x1, state, cfg):
    d, H, dh, fd = _slstm_dims(cfg)
    B = x1.shape[0]
    hin = apply_norm(x1, p["ln1"], cfg.norm)
    cd = acc_dtype(x1)
    W, R, b = _slstm_stacked(p, cd)
    x_pre = (hin @ W).to(cd).view(B, 4, H, dh)
    (c, n, m, h), _ = _slstm_step((R, b), (state["c"], state["n"], state["m"], state["h"]),
                                  (x_pre,))
    x1 = x1 + h.reshape(B, d).to(x1.dtype)
    return _slstm_ffn(p, x1, cfg), {"c": c, "n": n, "m": m, "h": h}
