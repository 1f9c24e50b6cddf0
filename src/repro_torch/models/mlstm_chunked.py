"""Chunkwise-parallel mLSTM: xlstm's default ``mlstm_form="chunkwise"``.

Port of ``repro/models/mlstm_chunked.py``.  The sequential cell updates
C_t = f_t C_{t-1} + i_t v_t k_tᵀ one step at a time; the recurrence is
linear in C, so a chunk of c steps collapses into matmuls (the same math,
reassociated):

  intra-chunk:  P_ts = (q_t·k_s) · exp(F_t − F_s + logi_s − m_t),  s ≤ t
  inter-chunk:  q_t·C_in scaled by exp(F_t + m_in − m_t)
  state update: C_out = e^{F_c+m_in−m_out} C_in + (diag(w) V)ᵀ K

where F_t = Σ_{s≤t} logf_s and m_* are the xLSTM log-scale stabilizers.  The
row stabilizer ``m_row`` is the closed form of the sequential max-plus
recurrence, masked pairs are ``NEG = -1e30``, and the xLSTM denominator
floor max(|n·q|, 1) is taken in the stabilized scale, as in the reference.
When a graph is built each chunk step runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.cost import fill_trips, trips

NEG = -1e30


def _chunk_step(C, n, m, q, k, v, li, lf):
    """One chunk.  C [B,H,d,d], n [B,H,d], m [B,H]; q, k, v [B,H,c,d];
    li, lf [B,H,c] -> (C, n, m) after the chunk, h [B,H,c,d]."""
    c = q.shape[2]
    Fc_all = torch.cumsum(lf, dim=-1)                    # F_t
    a = Fc_all + m[..., None]                            # log-scale of C_in at step t
    D = Fc_all[..., :, None] - Fc_all[..., None, :] + li[..., None, :]
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    D = torch.where(tri, D, NEG)
    m_row = torch.maximum(a, torch.amax(D, dim=-1))      # == the sequential m_t
    P = (q @ k.transpose(-1, -2)) * torch.exp(D - m_row[..., None])
    inter = torch.exp(a - m_row)
    num = P @ v + inter[..., None] * (q @ C.transpose(-1, -2))
    den = torch.sum(P, dim=-1) + inter * (q @ n[..., None])[..., 0]
    h = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
    # ---- state to the next chunk ----
    Fc = Fc_all[..., -1]
    w_log = Fc[..., None] - Fc_all + li
    m_new = torch.maximum(Fc + m, torch.amax(w_log, dim=-1))
    w = torch.exp(w_log - m_new[..., None])
    decay = torch.exp(Fc + m - m_new)
    C_new = decay[..., None, None] * C + (v * w[..., None]).transpose(-1, -2) @ k
    n_new = decay[..., None] * n + (w[..., None, :] @ k)[..., 0, :]
    return C_new, n_new, m_new, h


def chunk_size(S: int, chunk: int) -> int:
    """The largest divisor of S that is at most ``chunk``."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def mlstm_chunkwise(q, k, v, logi, logf, *, chunk: int = 128, initial=None):
    """q/k/v [B,S,H,dh] (k pre-scaled), logi/logf [B,S,H] -> (h [B,S,H,dh],
    (C, n, m) final); the math of the sequential scan over
    ``recurrent._mlstm_cell_step``, in chunks of :func:`chunk_size`."""
    B, S, H, dh = q.shape
    c = chunk_size(S, chunk)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))   # [B,H,S,dh]
    lih, lfh = logi.transpose(1, 2), logf.transpose(1, 2)  # [B,H,S]
    if initial is None:
        initial = (q.new_zeros((B, H, dh, dh)), q.new_zeros((B, H, dh)), q.new_zeros((B, H)))
    C, n, m = initial
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, logi, logf, C, n, m))
    hs = []
    for j in trips(S // c):      # identical trips: repro_torch.cost scales them
        i = j * c
        args = (C, n, m, qh[:, :, i:i + c], kh[:, :, i:i + c], vh[:, :, i:i + c],
                lih[:, :, i:i + c], lfh[:, :, i:i + c])
        C, n, m, h = (checkpoint(_chunk_step, *args, use_reentrant=False) if remat
                      else _chunk_step(*args))
        hs.append(h)
    return torch.cat(fill_trips(hs, S // c), dim=2).transpose(1, 2), (C, n, m)
