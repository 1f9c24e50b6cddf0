"""Fused selection→aggregate kernels on Hopper — port of
``repro/kernels/fused_agg.py``.

Two kernels carry the main path's device work (``csrc/fused_agg.cu``):

  K1 ``fused_round_step``    advance a carried SumState over one round-slice
                             (scalar: ``pf_scalar`` with a carry; group:
                             ``pf_group``; a bundle: ``pf_bundle``, every
                             member in one launch).  Serves every
                             ``kernel_fused`` session step and the engine's
                             group and bundle paths.
  K2 ``fused_prefix_states`` the running state after every chunk of a whole
                             shard (``pf_scalar`` with prefix output).  Serves
                             the engine's scalar ``emit="kernel"`` path.

The TPU kernels run the ``FusedSpec`` closures inside their body.  Here the
closures stay PyTorch: :func:`project` evaluates them on the round-slice on
the device and the CUDA kernels do the chunk-ordered, carry-in
accumulation.  The partition axis is a batch axis of one launch.  The
group modes run the group step of ``csrc/agg_common.cuh`` — per-chunk
partials into a scratch that the wrapper allocates (``ops.group_step_*``),
then an ordered fold onto the carry — in tiles of chunks; a call counts as
one launch however many tiles and grids it takes.

Encoded columns (``data/encodings.py``) arrive physical and K1's decode
stage — the reference's ``_decode_chunk``, in the Pallas body — is a
launch of its own here (``kernels/decode.py``, ``pf_decode``) ahead of
:func:`project`: the closures are PyTorch and read logical columns.

Join GLAs publish probe tables (``FusedSpec.probe_tables``): :func:`project`
puts them into the column dict under their keys before the closures run,
where the reference injects them into the Pallas body.  Whether a plan may
take this path at all is the reference's routing rule,
:func:`fused_available`.

The tensor-level wrappers (:func:`scalar_round_step`, :func:`scalar_prefix`,
:func:`group_round_step`, :func:`bundle_round_step`) check device, dtype,
shape and contiguity, run the plain version (``kernels/ref.py``) on CPU
tensors, and on CUDA tensors launch the kernel — or raise, never falling
back.  Each launch adds one to its kernel's count in :data:`LAUNCHES`,
and either route to :data:`DISPATCHES` (``kernels/_runtime.py``).  ``scanned`` is summed outside the kernels, as
in the reference: live counts are integers and need only ``_mask``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import estimators as E
from repro_torch import obs
from repro_torch.data import encodings as ENC
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import _runtime as RT
from repro_torch.kernels._runtime import (  # noqa: F401 — re-exported
    DISPATCHES,
    LAUNCHES,
    dispatch_counts,
    launch_counts,
    reset_launch_counts,
)

MAX_BUNDLE_MEMBERS = 16  # members in one pf_bundle launch (csrc kMaxMembers)
_TABLE_COLS = 14  # int64 slots per member row of pf_bundle's table (csrc kTableCols)

#: The reference's routing rule (``repro/kernels/fused_agg.py:63``,
#: ``PROBE_VMEM_BUDGET_BYTES``): a join whose probe tables exceed 4 MiB
#: does not take the fused kernel but the legacy ``kernel_cols`` path.
#: The budget is the reference TPU kernel's; the port keeps it so that a
#: plan takes the same path as in the reference, not as a limit of the
#: H100 (whose kernels here read the tables from device memory).
REFERENCE_PROBE_BUDGET_BYTES = 4 * 1024 * 1024

_F32, _I32 = RT.F32, RT.I32
_check, _route, _ptr = RT.check, RT.route, RT.ptr


def _lib() -> ctypes.CDLL:
    return RT.bind(_build.load("fused_agg"), pf_scalar=(6, 4),
                   pf_group=(10, 7), pf_bundle=(1, 5))


def _scalar(vals, w, carry, prefix: bool):
    P, C, L, A = vals.shape
    dev = vals.device
    _check("w", w, _F32, (P, C, L), dev)
    if carry is not None:
        _check("carry", carry, _F32, (P, 2 * A + 1), dev)
    count = "fused_prefix_states" if prefix else "fused_round_step/scalar"
    if _route(dev) == "plain":
        RT.plain(count)
        return (ref.scalar_prefix(vals, w) if prefix
                else ref.scalar_round_step(vals, w, carry))
    part = torch.empty((P, C, 2 * A + 1), dtype=_F32, device=dev)
    out = torch.empty((P, 2 * A + 1), dtype=_F32, device=dev)
    pre = torch.empty_like(part) if prefix else None
    lib = _lib()
    RT.launch(lib, lib.pf_scalar, _ptr(vals), _ptr(w), _ptr(part), _ptr(carry),
              _ptr(out), _ptr(pre), P, C, L, A, device=dev, count=count)
    return pre if prefix else out


def _check_vals(vals):
    if not isinstance(vals, torch.Tensor) or vals.ndim != 4:
        raise ValueError("vals must be a [P, C, L, A] tensor")
    _check("vals", vals, _F32, vals.shape, vals.device)
    if min(vals.shape[0], vals.shape[3]) < 1:
        raise ValueError("vals needs P >= 1 and A >= 1")


def scalar_round_step(vals: torch.Tensor, w: torch.Tensor,
                      carry: torch.Tensor) -> torch.Tensor:
    """K1, scalar: carry [P, 2A+1] = (sum | sumsq | matched) advanced over
    the C chunks of ``vals [P, C, L, A]`` / ``w [P, C, L]`` in chunk order."""
    _check_vals(vals)
    return _scalar(vals, w, carry, prefix=False)


def scalar_prefix(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K2: running (sum | sumsq | matched) after every chunk, [P, C, 2A+1]."""
    _check_vals(vals)
    return _scalar(vals, w, None, prefix=True)


def _check_group(vals, w, gids, carry_s, carry_q, carry_m):
    _check_vals(vals)
    P, C, L, A = vals.shape
    dev = vals.device
    G = carry_m.shape[-1] if carry_m.ndim == 2 else -1
    _check("w", w, _F32, (P, C, L), dev)
    _check("gids", gids, _I32, (P, C, L), dev)
    _check("carry_s", carry_s, _F32, (P, G, A), dev)
    _check("carry_q", carry_q, _F32, (P, G, A), dev)
    _check("carry_m", carry_m, _F32, (P, G), dev)
    if _route(dev) == "cuda" and L > RT.MAX_GROUP_ROWS:
        raise ValueError(f"group kernel sorts a chunk in shared memory: "
                         f"L={L} exceeds {RT.MAX_GROUP_ROWS}")


def group_round_step(vals, w, gids, carry_s, carry_q, carry_m):
    """K1, group: per-group sums over ``gids [P, C, L]`` added onto the
    carries ``[P, G, A]``, ``[P, G, A]``, ``[P, G]`` chunk by chunk."""
    _check_group(vals, w, gids, carry_s, carry_q, carry_m)
    P, C, L, A = vals.shape
    dev = vals.device
    if _route(dev) == "plain":
        RT.plain("fused_round_step/group")
        return ref.group_round_step(vals, w, gids, carry_s, carry_q, carry_m)
    G = carry_m.shape[-1]
    out_s, out_q = torch.empty_like(carry_s), torch.empty_like(carry_q)
    out_m = torch.empty_like(carry_m)
    tile = ops.group_step_tile(C, L, [(A, G)])
    scratch = ops.group_step_scratch(P, C, L, A, G, tile, dev)
    lib = _lib()
    RT.launch(lib, lib.pf_group, _ptr(vals), _ptr(w), _ptr(gids), _ptr(carry_s),
              _ptr(carry_q), _ptr(carry_m), _ptr(out_s), _ptr(out_q),
              _ptr(out_m), _ptr(scratch), P, C, L, A, G, tile,
              ops.group_step_words(L, A, G), device=dev,
              count="fused_round_step/group")
    return out_s, out_q, out_m


def bundle_round_step(members):
    """K1, bundle: every member advanced over the same ``C`` chunks in ONE
    launch (``pf_bundle``) of up to :data:`MAX_BUNDLE_MEMBERS` members (a
    larger bundle takes one launch per that many), each member's arithmetic
    that of its solo step, so each member's result is bitwise-equal to its
    solo launch.

    ``members`` holds ``(vals, w, None, carry)`` for a scalar member and
    ``(vals, w, gids, carry_s, carry_q, carry_m)`` for a group member, all
    with the same ``P, C, L``.  Returns the advanced carries in that order
    (a tensor for a scalar member, a triple for a group member)."""
    if not members:
        raise ValueError("a bundle launch needs one or more members, got none")
    _check_vals(members[0][0])
    P, C, L, _ = members[0][0].shape
    dev = members[0][0].device
    for m in members:
        if m[2] is None:
            _check_vals(m[0])
            _check("w", m[1], _F32, (P, C, L), dev)
            _check("carry", m[3], _F32, (P, 2 * m[0].shape[3] + 1), dev)
        else:
            _check_group(*m)
        if m[0].shape[:3] != (P, C, L):
            raise ValueError("bundle members need the same P, C, L")
    if _route(dev) == "plain":
        RT.plain("fused_round_step/bundle", -(-len(members) // MAX_BUNDLE_MEMBERS))
        return ref.bundle_round_step(members)
    outs = []
    for i in range(0, len(members), MAX_BUNDLE_MEMBERS):
        outs += _bundle_launch(members[i:i + MAX_BUNDLE_MEMBERS], P, C, L, dev)
    return outs


def _bundle_launch(members, P, C, L, dev):
    """One ``pf_bundle`` launch over at most MAX_BUNDLE_MEMBERS members."""
    table = torch.zeros((len(members), _TABLE_COLS), dtype=torch.int64)
    outs = []
    keep = []  # the scratch: the table holds only its address
    tile = ops.group_step_tile(C, L, [(m[0].shape[3], m[5].shape[-1])
                                      for m in members if m[2] is not None])
    for i, m in enumerate(members):
        A = m[0].shape[3]
        if m[2] is None:  # kind 0: carry in, out and [P, C, 2A+1] partials
            out = torch.empty_like(m[3])
            part = torch.empty((P, C, 2 * A + 1), dtype=_F32, device=dev)
            ptrs = (m[0], m[1], None, m[3], None, None, out, None, None, part)
            row, words = [0, A, 1], 0
            outs.append(out)
            keep.append(part)
        else:  # kind 1: group carries in and out, the group step's scratch
            G = m[5].shape[-1]
            out = tuple(torch.empty_like(c) for c in m[3:])
            scratch = ops.group_step_scratch(P, C, L, A, G, tile, dev)
            ptrs = (m[0], m[1], m[2], *m[3:], *out, scratch)
            row, words = [1, A, G], ops.group_step_words(L, A, G)
            outs.append(out)
            keep.append(scratch)
        table[i] = torch.tensor(row + [0 if t is None else t.data_ptr() for t in ptrs]
                                + [words])
    lib = _lib()
    RT.launch(lib, lib.pf_bundle, ctypes.c_void_p(table.data_ptr()),
              len(members), P, C, L, tile, device=dev,
              count="fused_round_step/bundle")
    return outs


# ---------------------------------------------------------------------------
# GLA-level entry points
# ---------------------------------------------------------------------------

def fused_members(gla):
    """The per-member ``FusedSpec`` tuple of ``gla`` (itself, or its bundle
    members), or None when any member lacks a fused contract."""
    specs = tuple(m.fused for m in (gla.members or (gla,)))
    return None if any(s is None for s in specs) else specs


def unique_probes(specs):
    """Unique ProbeTables across member specs, first-seen order (members
    that share a table object read it once)."""
    seen = {}
    for fs in specs:
        for pt in fs.probe_tables:
            seen.setdefault(pt.key, pt)
    return tuple(seen.values())


def probe_bytes(gla) -> int:
    """Combined unique probe-table bytes of ``gla``'s fused contract (0
    when it has none)."""
    specs = fused_members(gla)
    return 0 if specs is None else sum(pt.nbytes for pt in unique_probes(specs))


def fused_available(gla, columns=None) -> bool:
    """The reference's rule: True when every member publishes a fused
    contract, every column of the source's table (``columns``, a tuple of
    ``ColumnSpec``) is kernel-decodable — no trailing dims — and the probe
    tables fit :data:`REFERENCE_PROBE_BUDGET_BYTES`."""
    if columns is not None and any(c.trailing for c in columns):
        return False
    return (fused_members(gla) is not None
            and probe_bytes(gla) <= REFERENCE_PROBE_BUDGET_BYTES)


def project(fs, cols):
    """Evaluate the FusedSpec closures on ``cols`` ({name: [P, C, L]}), with
    ``fs``'s probe tables put into the column dict under their keys first,
    as the reference injects them into the in-kernel column dict: (vals
    [P, C, L, A] f32, w = cond·_mask [P, C, L] f32, gids i32 or None),
    contiguous, on the columns' device."""
    if fs.probe_tables:
        cols = {**cols, **{pt.key: pt.values for pt in fs.probe_tables}}
    mask = cols["_mask"]
    vals = fs.func(cols)
    if vals.ndim == mask.ndim:
        vals = vals.unsqueeze(-1)
    vals = vals.to(_F32).contiguous()
    w = (fs.cond(cols) * mask).to(_F32).contiguous()
    gids = None if fs.group is None else fs.group(cols).to(_I32).contiguous()
    return vals, w, gids


def _live_counts(mask: torch.Tensor) -> torch.Tensor:
    """Live rows per (partition, chunk), [P, C] float64 — exact integers.

    A chunk's 0/1 rows sum exactly in float32 up to 2**24 rows, so only the
    [P, C] result is widened: summing in float64 would first make a float64
    copy of the whole mask (twice a float32 mask's bytes on the device)."""
    exact32 = mask.shape[-1] <= 1 << 24
    return mask.sum(dim=-1, dtype=torch.float32 if exact32 else torch.float64).double()


def _fused_specs(gla):
    specs = fused_members(gla)
    if specs is None:
        raise ValueError(f"GLA {gla.name!r} does not publish a fused kernel contract")
    pbytes = probe_bytes(gla)
    if pbytes > REFERENCE_PROBE_BUDGET_BYTES:
        raise ValueError(
            f"GLA {gla.name!r}: probe tables of {pbytes} bytes exceed the "
            f"reference's {REFERENCE_PROBE_BUDGET_BYTES}-byte fused budget — "
            "this plan takes the legacy kernel_cols path")
    return specs


def _member_args(fs, state: E.SumState, cols: dict, member: int = 0) -> tuple:
    """One member's kernel operands: (vals, w, None, carry) for a scalar
    contract, (vals, w, gids, carry_s, carry_q, carry_m) for a group one;
    ``member`` is its index in the bundle."""
    with obs.span("pfola.project", member=member):
        vals, w, gids = project(fs, cols)
    if gids is None:
        carry = torch.cat([state.sum, state.sumsq, state.matched[:, None]],
                          dim=1).contiguous()
        return vals, w, None, carry
    return (vals, w, gids, state.sum.contiguous(), state.sumsq.contiguous(),
            state.matched.contiguous())


def _member_state(out, A: int, scanned) -> E.SumState:
    if isinstance(out, torch.Tensor):  # scalar (sum | sumsq | matched)
        return E.SumState(sum=out[:, :A], sumsq=out[:, A:2 * A],
                          scanned=scanned, matched=out[:, 2 * A])
    s, q, m = out
    return E.SumState(sum=s, sumsq=q, scanned=scanned, matched=m)


def fused_round_step(gla, state, cols: dict, encodings=()):
    """K1: advance the per-partition ``state`` (leaves [P, ...]; a tuple of
    member states for a bundle) over one round-slice ``cols``
    ({name: [P, C, L]}, incl. ``_mask``).  The columns named in
    ``encodings`` arrive physical — [P, C, L/lanes], or int8/int16 codes —
    and K1's decode stage turns them logical first, in ONE ``pf_decode``
    launch for all of them and every bundle member.  A bundle takes ONE
    ``pf_bundle`` launch for every member; ``scanned`` is summed once,
    outside the kernel."""
    specs = _fused_specs(gla)
    if encodings:
        with obs.span("pfola.decode"):
            cols = ENC.decode_cols(cols, encodings)
    is_bundle = bool(gla.members)  # torch-contracts: allow(C003)
    states = tuple(state) if is_bundle else (state,)
    delta = _live_counts(cols["_mask"]).sum(dim=1).to(_F32)
    args = [_member_args(fs, st, cols, i) for i, (fs, st) in enumerate(zip(specs, states))]
    if is_bundle:
        with obs.span("pfola.kernel", kernel="bundle"):
            outs = bundle_round_step(args)
    elif args[0][2] is None:
        with obs.span("pfola.kernel", kernel="scalar"):
            outs = [scalar_round_step(args[0][0], args[0][1], args[0][3])]
    else:
        with obs.span("pfola.kernel", kernel="group"):
            outs = [group_round_step(*args[0])]
    new = [_member_state(o, a[0].shape[-1], st.scanned + delta)
           for o, a, st in zip(outs, args, states)]
    return tuple(new) if is_bundle else new[0]


def fused_prefix_states(gla, cols: dict, encodings=()):
    """K2: whole-shard scalar scan of ``cols`` ({name: [P, C, L]}, encoded
    columns decoded first as in :func:`fused_round_step`) emitting
    per-chunk prefixes.  Returns ``(final, prefixes)``: leaves [P, ...] and
    [P, C + 1, ...] (row 0 is init(), row c+1 the state after chunk c)."""
    specs = _fused_specs(gla)
    cols = ENC.decode_cols(cols, encodings)
    fs = specs[0]
    if gla.members or fs.group is not None:
        raise ValueError(f"fused_prefix_states needs a scalar GLA, got {gla.name!r}")
    vals, w, _ = project(fs, cols)
    P, _, _, A = vals.shape
    pre = scalar_prefix(vals, w)
    zero = torch.zeros((P, 1, 2 * A + 1), dtype=_F32, device=pre.device)
    pre = torch.cat([zero, pre], dim=1)  # [P, C+1, 2A+1]
    counts = _live_counts(cols["_mask"])
    scanned = torch.cat([torch.zeros_like(counts[:, :1]), counts.cumsum(dim=1)],
                        dim=1).to(_F32)
    prefixes = E.SumState(sum=pre[..., :A], sumsq=pre[..., A:2 * A],
                          scanned=scanned, matched=pre[..., 2 * A])
    final = E.SumState(*(x[:, -1] for x in prefixes))
    return final, prefixes
