"""Port parity for checkpoints and elastic resume (``repro_torch.ckpt``,
``Session.pause``/``Session.resume``, ``data.source.RepartitionedSource``,
``scan.merge_carries``/``split_carries``).

The reference's sizes (8192 rows, P=4, 4 rounds, chunk_len 256).  Against
the reference, on the same numpy shards: ``RepartitionedSource`` slices,
per-chunk counts and fingerprints bitwise for merge and split, the carry
algebra bitwise, and elastic finals within rtol=1e-6.  Within the port:
pause/resume bitwise the uninterrupted run on every session path (in this
process, in a fresh one, over a streamed source), elastic finals within
rtol=1e-6 of the uninterrupted run (bitwise for a count), and every
named-field mismatch a ``ValueError`` raised before a session is built.  A
reference msgpack envelope is refused as foreign.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch as T
from repro.core import gla as RG
from repro.core import randomize as RR
from repro.core import scan as RSC
from repro.core import session as RS
from repro.data import source as RD
from repro.data import tpch as RT
from repro_torch import ckpt
from repro_torch import scan as TSC
from repro_torch import session as TS
from repro_torch.data import source as TD
from repro_torch.data import tpch as TT
from repro_torch.uda import tree_map

REPO = Path(__file__).resolve().parents[1]
ROWS, P, ROUNDS, L = 8192, 4, 4, 256  # C = 8: two chunks a round


@pytest.fixture(scope="module")
def shards():
    raw = RT.generate_lineitem(ROWS, seed=21)
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in raw.items()},
                                jax.random.key(4), P)
    return {k: np.asarray(v) for k, v in RR.pack_partitions(parts, chunk_len=L).items()}


@pytest.fixture(scope="module")
def t_shards(shards):
    return {k: torch.from_numpy(v.copy()) for k, v in shards.items()}


def _q6(pkg="port", estimator="single"):
    if pkg == "ref":
        return RG.make_sum_gla(RT.q6_func, RT.q6_cond(RT.Q6_LOW_WINDOW),
                               d_total=float(ROWS), estimator=estimator)
    return T.make_sum_gla(TT.q6_func, TT.q6_cond(TT.Q6_LOW_WINDOW),
                          d_total=float(ROWS), estimator=estimator)


def _count():
    """COUNT(*): integer-valued f32 sums, exact in any association."""
    def one(c):
        return torch.ones_like(c["quantity"])

    return T.make_sum_gla(one, one, d_total=float(ROWS))


def _q1():
    return T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small,
                              num_groups=4, d_total=float(ROWS), num_aggs=4)


def _drive(sess):
    while not sess.done:
        sess.step()
    return sess.result()


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.numpy().tobytes() == y.numpy().tobytes()


def _session(gla, data, **kw):
    return T.Session(T.QuerySpec(gla, rounds=ROUNDS, **kw), data, device="cpu")


# ---------------------------------------------------------------------------
# the repartitioned view, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pnew", [1, 2, 8, 16])
@pytest.mark.parametrize("inner", ["memory", "npy"])
def test_repartition_view_equals_reference(shards, t_shards, tmp_path, pnew, inner):
    if inner == "npy":
        d = RD.NpyMmapSource.save(shards, tmp_path / "npy")
        t_src, r_src = T.NpyMmapSource(d), RD.NpyMmapSource(d)
    else:
        t_src, r_src = TD.InMemorySource(t_shards), RD.as_source(shards)
    tv, rv = T.repartition(t_src, pnew), RD.repartition(r_src, pnew)
    assert tv.spec.P == rv.spec.P == pnew and tv.spec.C == rv.spec.C
    assert tv.device_slices == (inner == "memory") and not tv.resident
    np.testing.assert_array_equal(tv.mask_chunk_sums(), rv.mask_chunk_sums())
    assert tv.fingerprint() == rv.fingerprint()
    C = tv.spec.C
    for lo, hi in ((0, C), (1, max(2, C // 2)), (C - 1, C)):
        got, want = tv.slice_cols(lo, hi), rv.slice_cols(lo, hi)
        assert sorted(got) == sorted(want)
        for k in want:
            g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
            assert g.dtype == np.asarray(want[k]).dtype
            assert g.tobytes() == np.asarray(want[k]).tobytes()
    like = tv.step_slice_like(2)
    buf = {k: np.empty(shape, dt) for k, (shape, dt) in like.items()}
    tv.read_into(0, 2, buf)
    for k, v in rv.slice_cols(0, 2).items():
        assert buf[k].tobytes() == np.asarray(v).tobytes()


@pytest.mark.parametrize("k", [2, 4])
def test_merge_and_split_are_mutual_inverses(t_shards, k):
    src = TD.InMemorySource(t_shards)
    for first in (P // k, P * k):
        view = TD.RepartitionedSource(TD.RepartitionedSource(src, first), P)
        a, b = view.slice_cols(0, src.spec.C), src.slice_cols(0, src.spec.C)
        for name in b:
            assert torch.equal(a[name], b[name])
        assert T.repartition(T.repartition(src, first), P) is src


def test_repartition_validates(t_shards):
    src = TD.InMemorySource({"_mask": torch.ones((4, 6, 8))})
    with pytest.raises(ValueError, match="divide"):
        T.repartition(src, 3)
    with pytest.raises(ValueError, match="chunk count"):
        TD.RepartitionedSource(src, 16)  # split factor 4 but C=6
    with pytest.raises(TypeError, match="ChunkSource"):
        TD.RepartitionedSource(t_shards, 2)
    assert T.repartition(src, 4) is src


# ---------------------------------------------------------------------------
# the carry algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", [1, 2, 4])
def test_carry_algebra_equals_reference(group):
    rng = np.random.default_rng(group)
    x = {"a": rng.normal(size=(8,)).astype(np.float32),
         "b": rng.normal(size=(8, 3, 2)).astype(np.float32)}
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    r = {k: jnp.asarray(v) for k, v in x.items()}
    for t_fn, r_fn in ((TSC.merge_carries, RSC.merge_carries),
                       (TSC.split_carries, RSC.split_carries)):
        got, want = t_fn(t, group), r_fn(r, group)
        for k in x:
            assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes()


@settings(max_examples=20, deadline=None, database=None)
@given(st.integers(min_value=0, max_value=3),
       st.lists(st.floats(min_value=-1e6, max_value=1e6, width=32),
                min_size=8, max_size=8))
def test_split_then_merge_is_the_identity(kpow, vals):
    """x + 0 is exact for every float but -0.0 (canonicalized to +0.0)."""
    k = 2 ** kpow
    x = torch.tensor(vals, dtype=torch.float32)
    got = TSC.merge_carries(TSC.split_carries({"a": x}, k), k)["a"]
    assert torch.equal(got, x)
    nz = x != 0
    assert got[nz].numpy().tobytes() == x[nz].numpy().tobytes()


@settings(max_examples=20, deadline=None, database=None)
@given(st.lists(st.floats(min_value=-1e6, max_value=1e6, width=32),
                min_size=8, max_size=8))
def test_merge_then_split_keeps_what_a_merge_sees(vals):
    """P -> P/2 -> P cannot restore where each carry was, but a merge of
    the re-split carries gives the merged carries back (up to the sign of
    a zero, as above)."""
    down = TSC.merge_carries({"a": torch.tensor(vals, dtype=torch.float32)}, 2)["a"]
    again = TSC.merge_carries(TSC.split_carries({"a": down}, 2), 2)["a"]
    assert torch.equal(again, down)
    nz = down != 0
    assert again[nz].numpy().tobytes() == down[nz].numpy().tobytes()


# ---------------------------------------------------------------------------
# pause / resume within the port: bitwise
# ---------------------------------------------------------------------------

def _paths():
    q6, q1 = _q6(), _q1()
    return {"scan": (q6, "chunk"), "scan/multiple": (_q6(estimator="multiple"), "round"),
            "kernel_fused": (q6, "kernel"), "kernel_fused/group": (q1, "kernel"),
            "kernel_fused/bundle": (T.GLABundle([q6, q1]), "kernel"),
            "kernel_group": (q1.with_(fused=None), "kernel"),
            "kernel_scalar": (q6.with_(fused=None), "kernel"),
            "kernel_bundle": (T.GLABundle([q6.with_(fused=None), q1.with_(fused=None)]),
                              "kernel")}


@pytest.mark.parametrize("case", list(_paths()))
@pytest.mark.parametrize("at", [0, 1, 3])
def test_pause_resume_is_bitwise(t_shards, tmp_path, case, at):
    gla, emit = _paths()[case]
    ref = _drive(_session(gla, t_shards, emit=emit))
    sess = _session(gla, t_shards, emit=emit)
    assert sess._path == case.split("/")[0]
    for _ in range(at):
        sess.step()
    sess.pause(tmp_path / "s.ckpt")
    back = TS.Session.resume(tmp_path / "s.ckpt", gla, t_shards, device="cpu")
    assert back.steps_taken == at and back._path == sess._path
    res = _drive(back)
    _bitwise((res.final, res.snapshots, res.estimates),
             (ref.final, ref.snapshots, ref.estimates))


def test_pause_resume_streamed_and_in_a_fresh_process(shards, t_shards, tmp_path):
    """A session streamed from an npy directory paused after one round
    resumes over the resident shards (same fingerprint) and, in a fresh
    interpreter, over the npy directory again: both bitwise the
    uninterrupted run."""
    d = RD.NpyMmapSource.save(shards, tmp_path / "npy")
    gla = _q1()
    ref = _drive(_session(gla, t_shards, emit="kernel"))
    sess = _session(gla, T.NpyMmapSource(d), emit="kernel")
    sess.step()
    ck = tmp_path / "stream.ckpt"
    sess.pause(ck)
    res = _drive(TS.Session.resume(ck, gla, t_shards, device="cpu"))
    _bitwise((res.final, res.estimates), (ref.final, ref.estimates))
    code = textwrap.dedent(f"""
        import hashlib, repro_torch as T
        from repro_torch.data import tpch as TT
        from repro_torch.uda import tree_map
        g = T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small,
                               num_groups=4, d_total={float(ROWS)}, num_aggs=4)
        s = T.Session.resume({str(ck)!r}, g, T.NpyMmapSource({str(d)!r}), device="cpu")
        while not s.done:
            s.step()
        r = s.result()
        h = hashlib.sha256()
        tree_map(lambda x: h.update(x.numpy().tobytes()), (r.final, r.estimates))
        print(s.steps_taken, h.hexdigest())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    import hashlib
    h = hashlib.sha256()
    tree_map(lambda x: h.update(x.numpy().tobytes()), (ref.final, ref.estimates))
    assert out.stdout.split() == [str(ROUNDS), h.hexdigest()]


def test_resume_with_fault_record(t_shards, tmp_path):
    """The failure record and estimator family come back from the
    checkpoint; the finished run is bitwise the uninterrupted chaos run."""
    g = _q6()
    spec = dict(fault=T.FaultPolicy("single", fail_at={2: 1}))
    ref = _drive(_session(g, t_shards, **spec))
    sess = _session(g, t_shards, **spec)
    sess.step()
    sess.step()
    sess.pause(tmp_path / "f.ckpt")
    back = TS.Session.resume(tmp_path / "f.ckpt", g, t_shards, device="cpu")
    assert back._policy.estimator == "single" and back._fail_at == {2: 1}
    res = _drive(back)
    _bitwise((res.final, res.estimates), (ref.final, ref.estimates))


@pytest.mark.parametrize("snapshots", [True, False])
def test_resumed_synchronized_stall(t_shards, tmp_path, snapshots):
    """A synchronized session that lost a partition before its pause stays
    frozen at the last pre-failure round after the resume when its history
    was kept (bitwise the uninterrupted run); with snapshots=False there is
    no history, and the rounds after the resume get infinite bounds (the
    reference's rule)."""
    g = _q6(estimator="synchronized")
    spec = dict(fault=T.FaultPolicy("synchronized", fail_at={1: 1}),
                snapshots=snapshots)
    sess = _session(g, t_shards, **spec)
    sess.step()
    frozen = sess.step().estimates
    sess.pause(tmp_path / "y.ckpt")
    back = TS.Session.resume(tmp_path / "y.ckpt", g, t_shards, device="cpu")
    later = [back.step().estimates for _ in range(2)]
    if snapshots:
        ref = _drive(_session(g, t_shards, **spec))
        _bitwise(back.result().estimates, ref.estimates)
        for e in later:
            _bitwise(e, frozen)
    else:
        for e in later:
            assert torch.isneginf(e.lower).all() and torch.isposinf(e.upper).all()


# ---------------------------------------------------------------------------
# elastic resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pnew", [2, 1, 8])
def test_elastic_final_matches_uninterrupted_and_reference(shards, t_shards,
                                                           tmp_path, pnew):
    g = _q6()
    ref = _drive(_session(g, t_shards))
    sess = _session(g, t_shards)
    sess.step()
    sess.step()
    sess.pause(tmp_path / "e.ckpt")
    back = TS.Session.resume(tmp_path / "e.ckpt", g, t_shards, partitions=pnew,
                             device="cpu")
    assert back._P == pnew and back.steps_taken == 2
    assert isinstance(back._source, TD.RepartitionedSource) and back._prefetch is None
    final = _drive(back).final
    np.testing.assert_allclose(final.numpy(), ref.final.numpy(), rtol=1e-6)
    rsess = RS.Session(_q6("ref"), shards, rounds=ROUNDS)
    rsess.step()
    rsess.step()
    rsess.pause(tmp_path / "r.ckpt")
    rback = RS.Session.resume(tmp_path / "r.ckpt", _q6("ref"), shards, partitions=pnew)
    np.testing.assert_allclose(final.numpy(), np.asarray(_drive(rback).final),
                               rtol=1e-6)


@pytest.mark.parametrize("pnew", [2, 8])
def test_elastic_count_is_bitwise(t_shards, tmp_path, pnew):
    g = _count()
    ref = _drive(_session(g, t_shards))
    sess = _session(g, t_shards)
    sess.step()
    sess.pause(tmp_path / "c.ckpt")
    res = _drive(TS.Session.resume(tmp_path / "c.ckpt", g, t_shards, partitions=pnew,
                                   device="cpu"))
    _bitwise(res.final, ref.final)
    _bitwise(res.snapshots.scanned, ref.snapshots.scanned)


@pytest.mark.parametrize("emit", ["chunk", "kernel"])
def test_elastic_round_trip_p_pprime_p(t_shards, tmp_path, emit):
    """4 -> P' -> 4: the elastically resumed session paused again comes
    back on the original layout (over the original data, not a view of a
    view); the final still matches."""
    for g in (_q6(), _q1()):
        ref = _drive(_session(g, t_shards, emit=emit))
        for pnew in (2, 8):
            sess = _session(g, t_shards, emit=emit)
            sess.step()
            sess.pause(tmp_path / "a.ckpt")
            mid = TS.Session.resume(tmp_path / "a.ckpt", g, t_shards, partitions=pnew,
                                    device="cpu")
            mid.step()
            mid.pause(tmp_path / "b.ckpt")
            back = TS.Session.resume(tmp_path / "b.ckpt", g, t_shards, partitions=P,
                                     device="cpu")
            assert back._P == P and back.steps_taken == 2
            assert back._source.resident  # the view collapsed to the data
            res = _drive(back)
            torch.testing.assert_close(res.final, ref.final, rtol=1e-6,
                                       atol=1e-6 * ref.final.abs().max().item())


# ---------------------------------------------------------------------------
# validation: named ValueErrors before a session is built
# ---------------------------------------------------------------------------

@pytest.fixture()
def paused(t_shards, tmp_path):
    sess = _session(_q6(), t_shards)
    sess.step()
    ck = tmp_path / "v.ckpt"
    sess.pause(ck)
    return ck


@pytest.fixture()
def no_session(monkeypatch):
    """Constructing a Session (the first device work of a resume) fails."""
    def refuse(*a, **k):
        raise AssertionError("a session was built before the mismatch was named")

    monkeypatch.setattr(TS.Session, "__init__", refuse)


def _take(tree, n):
    return {k: v[:n] for k, v in tree.items()}


@pytest.mark.parametrize("field", ["gla", "P", "C", "L", "fingerprint", "rounds",
                                   "version"])
def test_resume_names_the_mismatched_field(paused, t_shards, no_session, field):
    g = _q6()
    data = t_shards
    if field == "gla":
        g = _q6(estimator="multiple")
    elif field == "P":
        data = _take(t_shards, 3)  # 3-way data is not repartition-compatible
    elif field == "C":
        data = _take(t_shards, 2)  # 2-way is: the surviving disagreement is C
    elif field == "L":
        data = {k: torch.cat([v, v], dim=2) for k, v in t_shards.items()}
    elif field == "fingerprint":
        data = {**t_shards, "quantity": t_shards["quantity"] + 1}
    else:
        meta, blob = ckpt.load_envelope(paused)
        if field == "rounds":
            meta["rounds"] = 7
        else:
            meta["version"] = 4
        ckpt.save_envelope(paused, meta, blob)
    match = {"rounds": "rounds 7", "version": "unsupported session checkpoint",
             "fingerprint": "fingerprint"}.get(field, f"checkpoint mismatch: {field}")
    with pytest.raises(ValueError, match=match):
        TS.Session.resume(paused, g, data, device="cpu")


def test_resume_fault_family_and_elastic_rejections(t_shards, tmp_path, paused):
    g = _q6()
    sess = _session(g, t_shards, fault=T.FaultPolicy("single"))
    sess.step()
    sess.pause(tmp_path / "fam.ckpt")
    with pytest.raises(ValueError, match="fault estimator family"):
        TS.Session.resume(tmp_path / "fam.ckpt", g, t_shards,
                          fault=T.FaultPolicy("synchronized"), device="cpu")
    with pytest.raises(ValueError, match="repartition 4 -> 3"):
        TS.Session.resume(paused, g, t_shards, partitions=3, device="cpu")
    dead = _session(g, t_shards, fault=T.FaultPolicy("single", fail_at={1: 0}))
    dead.step()
    dead.pause(tmp_path / "dead.ckpt")
    with pytest.raises(ValueError, match="all-alive"):
        TS.Session.resume(tmp_path / "dead.ckpt", g, t_shards, partitions=2,
                          device="cpu")
    whole = _session(g, t_shards)
    whole.run()
    with pytest.raises(RuntimeError, match="whole-scan"):
        whole.pause(tmp_path / "w.ckpt")


def test_reference_envelope_is_refused_as_foreign(shards, t_shards, tmp_path):
    rsess = RS.Session(_q6("ref"), shards, rounds=ROUNDS)
    rsess.step()
    rsess.pause(tmp_path / "ref.ckpt")
    with pytest.raises(ValueError, match="foreign checkpoint"):
        TS.Session.resume(tmp_path / "ref.ckpt", _q6(), t_shards, device="cpu")
    (tmp_path / "junk.ckpt").write_bytes(ckpt.MAGIC + b"\xff" * 4)
    with pytest.raises(ValueError, match="foreign checkpoint"):
        ckpt.load_envelope(tmp_path / "junk.ckpt")


def test_envelope_fields(t_shards, tmp_path):
    sess = _session(_q6(), t_shards, fault=T.FaultPolicy("single", fail_at={2: 3}))
    sess.step()
    sess.pause(tmp_path / "m.ckpt")
    meta, blob = ckpt.load_envelope(tmp_path / "m.ckpt")
    assert meta["version"] == 3 and meta["framework"] == "repro_torch"
    assert meta["cursors"] == [2] * P  # one round of a C=8, 4-round schedule
    assert meta["fail_at"] == [[2, 3]] and meta["fault_estimator"] == "single"
    assert meta["fingerprint"] == TD.InMemorySource(t_shards).fingerprint()
    assert (tmp_path / "m.ckpt").read_bytes().startswith(ckpt.MAGIC) and blob
    assert not list(tmp_path.glob("*.tmp"))  # written atomically


def test_state_round_trip_is_bitwise():
    state = {"a": torch.tensor([1.5, -np.inf, np.inf, -0.0, np.nan]),
             "b": (torch.arange(6, dtype=torch.int32).reshape(2, 3), None,
                   torch.tensor(True)),
             "c": T.Estimate(torch.zeros(2), torch.ones(2), torch.ones(2),
                             info={"var": torch.full((2,), np.inf)})}
    back = ckpt.deserialize_state(ckpt.serialize_state(state), state)
    for x, y in zip(_leaves(state), _leaves(back), strict=True):
        assert x.dtype == y.dtype and x.numpy().tobytes() == y.numpy().tobytes()
    with pytest.raises(ValueError, match="structure"):
        ckpt.deserialize_state(ckpt.serialize_state(state), {"a": state["a"]})
