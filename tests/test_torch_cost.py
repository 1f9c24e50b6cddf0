"""The port's op counter (``repro_torch.cost``) against the reference's
loop-aware HLO cost analysis (``repro.analysis.hlo_cost``), its loop
scaling against full counts, its byte rules, and the profiler-trace reader.

Tolerances:
* the reference's own test functions (a scan of matmuls against its
  unroll, nested scans, ``dot_general`` with contracting dims): flops equal
  exactly — the port's loops are Python loops of the same matmuls and
  ``tanh``s;
* each smoke config's prefill forward: the matmul flops equal the
  reference's dot flops exactly, and the total within 2e-3 (measured: at
  most 1.6e-3, grok-1 and recurrentgemma).  The two count the same
  transcendental rule on different programs: the reference's compiled
  attention runs an online softmax (an exp a key block and rescales) where
  the port takes one masked softmax, its ``jnp.var`` and ``logsumexp``
  lower to divides the port's fused ops do not show;
* loop scaling: the loop-scaled count (trip 0, trip 1 counted n - 2 times,
  trip n - 1) equals the full count exactly — flops, bytes, every op count
  and the peak of the live bytes — for the sLSTM's blocked scan and the
  mLSTM's chunks (forward, and a backward through checkpointed trips), a
  loop around such a scan, the microbatch loop of a train step, and a whole
  xlstm smoke prefill; a train step's flops on the CPU (full, real tensors)
  equal its loop-scaled count on ``meta``, and a loop-scaled count refuses
  tensors off ``meta``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from repro.analysis import hlo_cost
from repro.configs import get_config as rget
from repro.models import spec as RS
from repro.models import transformer as RT
from repro.serving import serve_step as RSS
from repro_torch import cost as C
from repro_torch import serve_step as SS
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs
from repro_torch.models import mlstm_chunked as MC
from repro_torch.models import recurrent as R
from repro_torch.models import spec as TS
from repro_torch.models import transformer as TT
from repro_torch.training import optimizer as O
from repro_torch.training import train_step as TST

META = torch.device("meta")


def _ref(fn, *args):
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())


def _meta(*shape, grad=False):
    return torch.empty(shape, device=META, requires_grad=grad)


# -- the reference's functions (tests/test_hlo_cost.py) ----------------------

def test_scan_of_matmuls_equals_the_reference_exactly():
    def body(x, w):
        return jnp.tanh(x @ w), None

    ref = _ref(lambda x, ws: lax.scan(body, x, ws)[0],
               jax.ShapeDtypeStruct((256, 256), jnp.float32),
               jax.ShapeDtypeStruct((10, 256, 256), jnp.float32))

    def port(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    got = C.analyze(port, _meta(256, 256), _meta(10, 256, 256))
    assert got["flops"] == ref["flops"] == 10 * (2 * 256**3 + 256**2)


def test_nested_scans_equal_the_reference_exactly():
    def inner(c, x):
        return c + jnp.sum(x @ x), None

    def outer(c, xs):
        return lax.scan(inner, c, xs)[0], None

    ref = _ref(lambda xs: lax.scan(outer, jnp.float32(0), xs)[0],
               jax.ShapeDtypeStruct((5, 7, 64, 64), jnp.float32))

    def port(xs):
        c = torch.zeros((), device=xs.device)
        for i in range(xs.shape[0]):
            for j in range(xs.shape[1]):
                c = c + torch.sum(xs[i, j] @ xs[i, j])
        return c

    got = C.analyze(port, _meta(5, 7, 64, 64))
    assert got["flops"] == ref["flops"] == 5 * 7 * 2 * 64**3


def test_dot_general_contracting_dims_equal_the_reference_exactly():
    ref = _ref(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
               jax.ShapeDtypeStruct((4, 32, 48), jnp.float32),
               jax.ShapeDtypeStruct((4, 48, 16), jnp.float32))
    got = C.analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                    _meta(4, 32, 48), _meta(4, 48, 16))
    assert got["flops"] == ref["flops"] == 2 * 4 * 32 * 16 * 48


# -- smoke prefills ----------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_smoke_prefill_flops_against_the_reference(arch):
    rcfg, tcfg = rget(arch).smoke(), tget(arch).smoke()
    B, S = 2, 64
    rb = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    tb = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
    for key, n, on in (("frames", rcfg.encoder_seq, rcfg.is_encoder_decoder),
                       ("patches", rcfg.vis_tokens, rcfg.frontend == "vision_stub")):
        if on:
            rb[key] = jax.ShapeDtypeStruct((B, n, rcfg.d_model), jnp.float32)
            tb[key] = torch.empty((B, n, rcfg.d_model), device=META)
    L = S + (rcfg.vis_tokens if rcfg.frontend == "vision_stub" else 0) + 8
    text = jax.jit(RSS.make_prefill(rcfg, L)).lower(
        RS.abstract_params(RT.param_specs(rcfg, dtype=jnp.float32)), rb).compile().as_text()
    ref_total = hlo_cost.analyze(text)["flops"]
    model = TT.Transformer(tcfg, TS.abstract_params(TT.param_specs(tcfg, torch.float32)))
    _, c = C.count(torch.no_grad()(SS.make_prefill(tcfg, L)), model, tb)
    saved = hlo_cost._TRANSCENDENTAL
    hlo_cost._TRANSCENDENTAL = ()          # the reference's dot flops alone
    try:
        ref_dots = hlo_cost.analyze(text)["flops"]
    finally:
        hlo_cost._TRANSCENDENTAL = saved
    assert c.matmul_flops() == ref_dots
    assert abs(c.cost.flops - ref_total) <= 2e-3 * ref_total


# -- byte rules ----------------------------------------------------------------

def test_views_count_nothing_and_a_slice_write_counts_the_slice():
    x = _meta(64, 1000, 8)
    assert C.analyze(lambda t: t.transpose(0, 1)[:3].unsqueeze(0).permute(0, 3, 1, 2), x)["bytes"] == 0

    def write(cache, k1):
        cache[:, 5] = k1              # a decode step's cache write: O(token)

    assert C.analyze(write, x, _meta(64, 8))["bytes"] == 2 * 64 * 8 * 4

    def scatter(buf, rows, vals):
        buf.index_put_((rows,), vals)

    rows = torch.empty(10, dtype=torch.long, device=META)
    assert C.analyze(scatter, _meta(100, 4), rows, _meta(10, 4))["bytes"] == 10 * 8 + 2 * 10 * 16
    assert C.analyze(lambda a, b: a + b, _meta(8, 4), _meta(4))["bytes"] == (32 + 4 + 32) * 4
    assert C.analyze(lambda a: a.expand(8, 4).contiguous(), _meta(1, 4))["bytes"] == (4 + 32) * 4
    # an in-place op reads and writes its target; out= only writes it
    assert C.analyze(lambda a, b: a.mul_(b), _meta(16), _meta(16))["bytes"] == 3 * 64
    assert C.analyze(lambda a, b, o: torch.mul(a, b, out=o),
                     _meta(16), _meta(16), _meta(16))["bytes"] == 3 * 64


def test_memory_follows_allocations_until_freed():
    def step(x):
        a = x * 2                     # 4 KB
        b = a + 1                     # 4 KB, a still live: peak 8 KB
        del a
        return b.sum()                # b is freed on return

    x = _meta(1024)                   # an argument: not the step's allocation
    with C.CostCounter(memory=True) as c:
        out = step(x)
    assert c.peak_bytes == 8192
    assert c.live_bytes == 4          # only the returned scalar
    del out
    assert c.live_bytes == 0


# -- loop scaling --------------------------------------------------------------

def _same(full, scaled):
    assert scaled.cost.flops == full.cost.flops
    assert scaled.cost.bytes == full.cost.bytes
    ops = {k: v for k, v in scaled.ops.items() if k != "empty_like"}   # fill_trips' padding
    assert ops == {k: v for k, v in full.ops.items() if v}
    assert scaled.peak_bytes == full.peak_bytes > 0


def _counts(fn, *args):
    """``fn(*args)`` counted in full and loop-scaled, with memory."""
    return (C.count(fn, *args, memory=True)[1],
            C.count(fn, *args, loop_scaled=True, memory=True)[1])


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
def test_loop_scaled_slstm_scan_equals_the_full_count(grad):
    B, S, H, dh = 2, 20, 2, 4       # 5 blocks of 4 steps

    def run():
        xp = _meta(S, B, 4, H, dh, grad=grad)
        R_ = _meta(H, dh, 4 * dh, grad=grad)
        b = _meta(4, H, dh, grad=grad)
        z = torch.zeros((B, H, dh), device=META)
        carry, ys = R._blocked_scan(R._slstm_step, (z, z, z, z), (xp,), 4, consts=(R_, b))
        if grad:
            torch.autograd.grad(ys.sum() + carry[0].sum(), [xp, R_, b])

    _same(*_counts(run))


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
def test_loop_scaled_mlstm_chunks_equal_the_full_count(grad):
    B, S, H, dh = 2, 20, 2, 8       # 5 chunks of 4

    def run():
        q, k, v = (_meta(B, S, H, dh, grad=grad) for _ in range(3))
        li, lf = (_meta(B, S, H, grad=grad) for _ in range(2))
        h, (Cf, nf, mf) = MC.mlstm_chunkwise(q, k, v, li, lf, chunk=4)
        if grad:
            torch.autograd.grad(h.sum(), [q, k, v, li, lf])

    _same(*_counts(run))


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
def test_loop_scaled_nested_loops_equal_the_full_count(grad):
    """An outer loop of 4 trips around an sLSTM scan of 7 blocks, its
    gradients summed into an accumulator as the microbatch loop does: the
    copies the middle trips stand for nest (2 × 5 of the inner ones)."""
    B, S, H, dh = 2, 28, 2, 4

    def run():
        R_ = _meta(H, dh, 4 * dh, grad=grad)
        b = _meta(4, H, dh, grad=grad)
        acc = torch.zeros((H, dh, 4 * dh), device=META)
        for _ in C.trips(4):
            xp = _meta(S, B, 4, H, dh, grad=grad)
            z = torch.zeros((B, H, dh), device=META)
            carry, ys = R._blocked_scan(R._slstm_step, (z, z, z, z), (xp,), 4, consts=(R_, b))
            if grad:
                acc.add_(torch.autograd.grad(ys.sum() + carry[0].sum(), [R_])[0])

    _same(*_counts(run))


def test_loop_scaled_count_refuses_tensors_off_meta():
    """A loop-scaled count leaves trips out, so it runs on ``meta`` only: on
    the CPU it raises before a trip is left out, and a train step there
    steps nothing."""
    with pytest.raises(RuntimeError, match="meta tensors only"):
        C.count(lambda x: x * 2, torch.ones(3), loop_scaled=True)
    # an empty tensor holds nothing (torch.utils.checkpoint makes one on the CPU)
    C.count(lambda x: (x * 2, torch.empty((0,), requires_grad=True)), _meta(3), loop_scaled=True)
    cfg = dataclasses.replace(tget("smollm_135m").smoke(), train_microbatches=4)
    model = TT.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    model.requires_grad_(True)
    opt = O.opt_init(model.params, cfg.optimizer)
    before = [t.detach().clone() for t in model.parameters()]
    tokens = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="meta tensors only"):
        C.count(TST.make_train_step(cfg), model, opt, {"tokens": tokens}, loop_scaled=True)
    assert all(torch.equal(a, t) for a, t in zip(before, model.parameters()))
    assert C.count_ops(lambda x: x @ x, "mm", torch.ones(2, 2)) == 1   # a full count runs anywhere


def test_loop_scaled_microbatches_equal_the_full_count():
    cfg = dataclasses.replace(tget("smollm_135m").smoke(), remat="full", train_microbatches=5)

    def run():
        model = TT.Transformer(cfg, TS.abstract_params(TT.param_specs(cfg, torch.float32)))
        model.requires_grad_(True)
        opt = O.opt_init(model.params, cfg.optimizer)
        tokens = torch.empty((5, 16), dtype=torch.int32, device=META)
        TST.make_train_step(cfg)(model, opt, {"tokens": tokens})

    _same(*_counts(run))


def test_loop_scaled_xlstm_prefill_equals_the_full_count():
    cfg = tget("xlstm_125m").smoke()
    model = TT.Transformer(cfg, TS.abstract_params(TT.param_specs(cfg, torch.float32)))
    tokens = {"tokens": torch.empty((1, 640), dtype=torch.int32, device=META)}  # 5 blocks
    fn = torch.no_grad()(SS.make_prefill(cfg, 640))
    _same(*_counts(fn, model, tokens))


def test_train_step_flops_on_the_cpu_equal_the_loop_scaled_meta_count():
    cfg = dataclasses.replace(tget("xlstm_125m").smoke(), remat="full")
    counts = {}
    for dev, scaled in (("cpu", False), ("meta", True)):
        if dev == "cpu":
            model = TT.init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
        else:
            model = TT.Transformer(cfg, TS.abstract_params(TT.param_specs(cfg, torch.float32)))
        model.requires_grad_(True)
        opt = O.opt_init(model.params, cfg.optimizer)
        batch = {"tokens": torch.zeros((1, 512), dtype=torch.int32, device=dev)}  # 4 blocks
        _, counts[dev] = C.count(TST.make_train_step(cfg), model, opt, batch, loop_scaled=scaled)
    assert counts["meta"].cost.flops == counts["cpu"].cost.flops
    assert counts["meta"].matmul_flops() == counts["cpu"].matmul_flops() > 0


def test_count_ops_and_breakdown():
    def fn(x, w):
        for _ in C.trips(6):
            x = x @ w
        return x

    x, w = _meta(8, 8), _meta(8, 8)
    assert C.count_ops(fn, "mm", x, w) == 6
    assert C.count(fn, x, w, loop_scaled=True)[1].count_ops("mm") == 6
    _, c = C.count(fn, x, w, breakdown=True)
    (key, nbytes), = c.bytes_breakdown(1)
    assert key.startswith("mm:8x8") and nbytes == 6 * 3 * 256


# -- the profiler reader -----------------------------------------------------

def _event(name, start, end, device=True):
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import FunctionEvent

    return FunctionEvent(id=0, name=name, thread=0, start_us=start, end_us=end,
                         device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_trace_summary_on_a_synthetic_event_list():
    events = [_event("ampere_sgemm_128x64", 0, 40), _event("pf_scalar_kernel", 30, 50),
              _event("ampere_sgemm_128x64", 80, 100), _event("cudaLaunchKernel", 0, 100, False),
              _event("memset", 100, 100)]
    s = C.trace_summary(events)
    assert s["kernels"] == 3                       # the zero-length memset is not shown
    assert s["device_ms"] == pytest.approx(0.08)
    assert s["busy_ms"] == pytest.approx(0.07)    # [0, 50] and [80, 100]
    assert s["window_ms"] == pytest.approx(0.1) and s["busy_share"] == pytest.approx(0.7)
    assert s["top"][0] == ("ampere_sgemm_128x64", pytest.approx(0.06), 2)
    assert s["gemm_ms"] == pytest.approx(0.06)
    assert [k for k, _, _ in C.trace_summary(events, top=None)["top"]] == [
        "ampere_sgemm_128x64", "pf_scalar_kernel"]
