"""Port parity for chunk sources and out-of-core sessions
(``repro_torch.data.source``, ``repro_torch.session``).

Numpy shards made by the reference's generator and randomizer (ragged: the
rows do not fill the last chunks) go through both packages:

  * fingerprints and ``mask_chunk_sums`` of in-memory, npy and encoded
    sources equal the reference's, and each package reads the directories
    the other wrote;
  * within the port every streamed run — and every encoded one — is
    bitwise the resident run on the same path (``scan``, ``kernel_fused``
    scalar/group/bundle, and the legacy ``kernel_group``,
    ``kernel_bundle`` and ``kernel_scalar``);
  * against the reference's streamed run on the same npy directory,
    counters are exact and sums within rtol=1e-5 (the two packages sum in
    another order);
  * routing (``Session._path``) equals the reference's for plain, encoded
    and trailing-dim sources.

On the CPU the prefetcher reads the slice and nothing more; its CUDA
staging path runs in ``test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as T
from repro.core import gla as RG
from repro.core import randomize as RR
from repro.core import session as RS
from repro.core.spec import QuerySpec as RQuerySpec
from repro.data import encodings as RE
from repro.data import source as RD
from repro.data import tpch as RT
from repro_torch import randomize as TR
from repro_torch.data import encodings as TE
from repro_torch.data import source as TD
from repro_torch.data import tpch as TT
from repro_torch.uda import tree_map

P, L, ROUNDS = 4, 128, 4
ROWS = 7_000  # not a multiple of P·L: ragged tails padded by _mask
RTOL = 1e-5


@pytest.fixture(scope="module")
def shards():
    raw = RT.generate_lineitem(ROWS, seed=19)
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in raw.items()},
                                jax.random.key(4), P)
    n_chunks = -(-ROWS // P // L)
    packed = RR.pack_partitions(parts, chunk_len=L,
                                min_chunks=-(-n_chunks // ROUNDS) * ROUNDS)
    return {k: np.asarray(v) for k, v in packed.items()}


def _encodings(shards, ref=False):
    E = RE if ref else TE
    return {"discount": E.dict_encoding_for(shards["discount"]),
            "quantity": E.dict_encoding_for(shards["quantity"]),
            "tax": E.dict_encoding_for(shards["tax"]),
            "shipdate": E.BitPackedEncoding(16), "rfls": E.BitPackedEncoding(2)}


@pytest.fixture(scope="module")
def dirs(shards, tmp_path_factory):
    """The reference's npy and encoded directories of the shards."""
    root = tmp_path_factory.mktemp("ref_sources")
    npy = RD.NpyMmapSource.save(shards, root / "npy")
    enc = RD.EncodedSource.save(shards, root / "enc", _encodings(shards, ref=True))
    return npy, enc


def _sources(shards, dirs):
    return {"memory": TD.InMemorySource(shards), "npy": TD.NpyMmapSource(dirs[0]),
            "encoded": TD.EncodedSource(dirs[1]),
            "encoded-in-memory": TD.EncodedSource.from_shards(shards, _encodings(shards))}


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_fingerprints_and_mask_sums_match_the_reference(shards, dirs):
    want_fp = RD.NpyMmapSource(dirs[0]).fingerprint()
    want_ms = RD.NpyMmapSource(dirs[0]).mask_chunk_sums()
    assert RD.InMemorySource({k: jnp.asarray(v) for k, v in shards.items()}
                             ).fingerprint() == want_fp
    assert RD.EncodedSource(dirs[1]).fingerprint() == want_fp
    for name, src in _sources(shards, dirs).items():
        assert src.fingerprint() == want_fp, name
        ms = src.mask_chunk_sums()
        assert ms.dtype == np.float64 and ms.tobytes() == want_ms.tobytes(), name
        assert repr(src.spec) == repr(RD.NpyMmapSource(dirs[0]).spec), name
    enc = TD.EncodedSource(dirs[1])
    ref_enc = RD.EncodedSource(dirs[1])
    assert enc.encodings == ref_enc.encodings
    assert enc.physical_columns() == ref_enc.physical_columns()
    changed = dict(shards, extendedprice=shards["extendedprice"] * np.float32(2))
    assert TD.InMemorySource(changed).fingerprint() != want_fp


def test_port_reads_reference_directories_and_the_reverse(shards, dirs, tmp_path):
    ref_npy, ref_enc = RD.NpyMmapSource(dirs[0]), RD.EncodedSource(dirs[1])
    mine_npy = TD.NpyMmapSource(TD.NpyMmapSource.save(shards, tmp_path / "npy"))
    mine_enc = TD.EncodedSource(TD.EncodedSource.save(
        shards, tmp_path / "enc", _encodings(shards)))
    assert ((tmp_path / "enc" / "encodings.json").read_text()
            == (dirs[1] / "encodings.json").read_text())
    back_npy, back_enc = RD.NpyMmapSource(tmp_path / "npy"), RD.EncodedSource(tmp_path / "enc")
    for port, ref in ((TD.NpyMmapSource(dirs[0]), ref_npy),
                      (TD.EncodedSource(dirs[1]), ref_enc),
                      (mine_npy, back_npy), (mine_enc, back_enc)):
        assert port.spec == ref.spec and port.fingerprint() == ref.fingerprint()
        a, b = port.slice_cols(2, 5), ref.slice_cols(2, 5)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
        like = port.step_slice_like(3)
        buf = {k: np.empty(shape, dt) for k, (shape, dt) in like.items()}
        port.read_into(2, 5, buf)
        assert all(buf[k].tobytes() == a[k].tobytes() for k in a)


def _glas(fused=True):
    d = float(ROWS)
    q6 = T.make_sum_gla(TT.q6_func, TT.q6_cond(TT.Q6_LOW_WINDOW), d_total=d)
    q1 = T.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small,
                            num_groups=4, d_total=d, num_aggs=4)
    if not fused:
        q6, q1 = q6.with_(fused=None), q1.with_(fused=None)
    return q6, q1


def _stepped(gla, data, emit, rounds=ROUNDS):
    """A session stepped through every round, and its result."""
    sess = T.Session(T.QuerySpec(gla, rounds=rounds, emit=emit), data, device="cpu")
    progs = [sess.step() for _ in range(rounds)]
    return sess, progs, sess.result()


@pytest.mark.parametrize("case", [
    "scan-q6", "scan-q1", "fused-scalar", "fused-group", "fused-bundle",
    "legacy-group", "legacy-bundle", "legacy-scalar"])
def test_streamed_and_encoded_runs_bitwise_resident(shards, dirs, case):
    q6, q1 = _glas(fused=not case.startswith("legacy"))
    gla = {"q6": q6, "scalar": q6, "q1": q1, "group": q1,
           "bundle": T.GLABundle([q6, q1])}[case.split("-")[1]]
    emit = "round" if case.startswith("scan") else "kernel"
    path = {"scan": "scan", "fused": "kernel_fused"}.get(case.split("-")[0]) or {
        "group": "kernel_group", "bundle": "kernel_bundle",
        "scalar": "kernel_scalar"}[case.split("-")[1]]
    base, base_progs, want = _stepped(gla, TD.InMemorySource(shards), emit)
    assert base._path == path and base.io_stats is None
    for name, src in _sources(shards, dirs).items():
        if name == "memory":
            continue
        sess = T.Session(T.QuerySpec(gla, rounds=ROUNDS, emit=emit), src, device="cpu")
        got = sess.run()  # a streaming source steps, with no stop rule too
        assert sess._path == path and sess.steps_taken == ROUNDS, name
        assert _same(got.final, want.final), name
        assert _same(got.snapshots, want.snapshots), name
        assert _same(got.estimates, want.estimates), name
        stats = sess.io_stats
        phys = sum(np.prod(s) * np.dtype(dt).itemsize
                   for s, dt in src.step_slice_like(src.spec.C // ROUNDS).values())
        assert stats["bytes"] == ROUNDS * phys, name


def test_streamed_matches_reference_streamed_run(shards, dirs):
    """The port's streamed kernel run against the reference's streamed scan
    over the same npy directory: counters exact, sums within rtol."""
    d = float(ROWS)
    refs = (RG.make_sum_gla(RT.q6_func, RT.q6_cond(RT.Q6_LOW_WINDOW), d_total=d),
            RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_small,
                                num_groups=4, d_total=d, num_aggs=4))
    for ref_gla, gla in zip(refs, _glas()):
        for ref_dir, cls in ((dirs[0], TD.NpyMmapSource), (dirs[1], TD.EncodedSource)):
            want = RS.Session(RQuerySpec(ref_gla, rounds=ROUNDS, emit="chunk"),
                              getattr(RD, cls.__name__)(ref_dir)).run()
            got = T.run_query(T.QuerySpec(gla, rounds=ROUNDS, emit="kernel"),
                              cls(ref_dir), device="cpu")
            for f in ("scanned", "matched"):
                np.testing.assert_array_equal(
                    getattr(got.snapshots, f).numpy(),
                    np.asarray(getattr(want.snapshots, f)), err_msg=f)
            for f in ("sum", "sumsq"):
                b = np.asarray(getattr(want.snapshots, f))
                np.testing.assert_allclose(getattr(got.snapshots, f).numpy(), b,
                                           rtol=RTOL, atol=RTOL * np.abs(b).max())
            b = np.asarray(want.final)
            np.testing.assert_allclose(got.final.numpy(), b, rtol=RTOL,
                                       atol=RTOL * np.abs(b).max())


def test_prefetch_reads_round_slices_only(dirs):
    """Each step consumes one prefetched round-slice and the source is
    never asked for more than one slice ahead."""
    calls = []

    class Spy(TD.NpyMmapSource):
        def slice_cols(self, lo, hi):
            calls.append((lo, hi))
            return super().slice_cols(lo, hi)

    src = Spy(dirs[0])
    src.mask_chunk_sums()  # its own bounded read of the mask, not a slice
    calls.clear()
    q6, _ = _glas()
    sess = T.Session(T.QuerySpec(q6, rounds=ROUNDS, emit="kernel"), src, device="cpu")
    sess.step()
    per = src.spec.C // ROUNDS
    sess._prefetch._ex.submit(lambda: None).result()  # the worker is idle
    assert calls == [(0, per), (per, 2 * per)]
    sess.run()
    assert calls == [(r * per, (r + 1) * per) for r in range(ROUNDS)]
    assert sess._prefetch is None  # closed when done


def test_streaming_requires_incremental_config(dirs):
    q6, _ = _glas()
    src = TD.NpyMmapSource(dirs[0])
    with pytest.raises(ValueError, match="streaming sources scan incrementally"):
        T.Session(T.QuerySpec(q6, rounds=ROUNDS, sync=True), src, device="cpu")
    sched = np.tile(np.array([0, 1, 3, 5, src.spec.C]), (P, 1))
    sched[0] = [0, 2, 3, 5, src.spec.C]  # not partition-uniform
    with pytest.raises(ValueError, match="streaming sources scan incrementally"):
        T.Session(T.QuerySpec(q6, schedule=sched), src, device="cpu")


def test_streamed_scanned_accounting_and_stop_rule(shards, dirs):
    """scanned/d_total per round equal the resident session's, and a stop
    rule ends a streamed session at the resident one's round."""
    q6, _ = _glas()
    _, base_progs, _ = _stepped(q6, shards, "kernel")
    _, progs, _ = _stepped(q6, TD.EncodedSource(dirs[1]), "kernel")
    assert [p.scanned for p in progs] == [p.scanned for p in base_progs]
    assert [p.d_total for p in progs] == [p.d_total for p in base_progs]
    assert progs[-1].scanned == float(shards["_mask"].sum())
    stop = T.budget(max_tuples=progs[1].scanned)
    for data in (shards, TD.NpyMmapSource(dirs[0])):
        sess = T.Session(T.QuerySpec(q6, rounds=ROUNDS, emit="kernel", stop=stop),
                         data, device="cpu")
        sess.run()
        assert sess.steps_taken == 2 and sess.converged


def test_exact_answer_on_a_source_equals_flat_rows(shards, dirs):
    flat = {k: torch.from_numpy(np.array(v.reshape(-1))) for k, v in shards.items()}
    _, q1 = _glas()
    for src in (TD.NpyMmapSource(dirs[0]), TD.EncodedSource(dirs[1])):
        for kw in ({}, {"group": TT.q1_group_small, "num_groups": 4}):
            want = TT.exact_answer(flat, TT.q1_func, TT.q1_cond, **kw)
            got = TT.exact_answer(src, TT.q1_func, TT.q1_cond, batch_rows=3 * P * L,
                                  **kw)
            torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


def test_run_queries_over_a_source_matches_resident(shards, dirs):
    q6, q1 = _glas()
    spec = T.QuerySpec([q6, q1], rounds=ROUNDS, emit="kernel")
    src = TD.EncodedSource(dirs[1])
    got = T.run_queries(spec, src, device="cpu")
    sess = T.Session(spec.with_(gla=T.GLABundle([q6, q1])), shards, device="cpu")
    while not sess.done:
        sess.step()
    want = sess.result()
    for i, r in enumerate(got):
        assert _same(r.final, want.final[i]) and _same(r.estimates, want.estimates[i])


@pytest.mark.parametrize("kind", ["plain", "encoded", "trailing"])
def test_session_path_matches_reference(shards, dirs, kind, tmp_path):
    """The port routes as the reference does, by the source's columns: a
    column with trailing dims takes the legacy kernels."""
    d = float(ROWS)
    ref_glas = [RG.make_sum_gla(RT.q6_func, RT.q6_cond(RT.Q6_LOW_WINDOW), d_total=d),
                RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_small,
                                    num_groups=4, d_total=d, num_aggs=4)]
    glas = list(_glas())
    ref_glas.append(RG.GLABundle(ref_glas[:2]))
    glas.append(T.GLABundle(glas[:2]))
    if kind == "plain":
        ref_src, src = RD.NpyMmapSource(dirs[0]), TD.NpyMmapSource(dirs[0])
    elif kind == "encoded":
        ref_src, src = RD.EncodedSource(dirs[1]), TD.EncodedSource(dirs[1])
    else:
        wide = dict(shards, pair=np.stack([shards["tax"]] * 2, axis=-1))
        ref_src = RD.NpyMmapSource(RD.NpyMmapSource.save(wide, tmp_path / "w"))
        src = TD.NpyMmapSource(tmp_path / "w")
        assert src.spec.columns == ref_src.spec.columns
    for ref_gla, gla in zip(ref_glas, glas):
        for emit in ("kernel", "chunk"):
            want = RS.Session(RQuerySpec(ref_gla, rounds=ROUNDS, emit=emit),
                              ref_src)._path
            got = T.Session(T.QuerySpec(gla, rounds=ROUNDS, emit=emit), src,
                            device="cpu")._path
            assert got == want, (gla.name, emit)
    if kind == "trailing":
        assert got == "scan"
        res = T.run_query(T.QuerySpec(glas[0], rounds=ROUNDS, emit="kernel"),
                          src, device="cpu")
        assert res.estimates is not None


# ---------------------------------------------------------------------------
# ParquetSource (``tests/test_source.py``'s parquet cases, against the
# reference's reader of the same files)
# ---------------------------------------------------------------------------

GROUP_ROWS = 3 * L  # row groups that do not align with chunks


@pytest.fixture(scope="module")
def parts():
    """The ragged partitions the ``shards`` fixture packs (live rows only)."""
    raw = RT.generate_lineitem(ROWS, seed=19)
    out = RR.randomize_global({k: jnp.asarray(v) for k, v in raw.items()},
                              jax.random.key(4), P)
    return [{k: np.asarray(v) for k, v in p.items()} for p in out]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_parquet_source_equals_the_reference_and_the_npy_copy(shards, dirs, parts,
                                                              writer, tmp_path):
    """Spec, fingerprint, mask sums and slices of the port's reader equal the
    reference's over the same files (either package's ``save``), and those
    of the npy copy of the same packing — a ragged tail padded to the
    packing's ``min_chunks``."""
    save = (RD if writer == "reference" else TD).ParquetSource.save
    d = save(parts, tmp_path / "pq", row_group_len=GROUP_ROWS)
    C = shards["_mask"].shape[1]
    src = TD.ParquetSource(d, chunk_len=L, min_chunks=C)
    ref = RD.ParquetSource(d, chunk_len=L, min_chunks=C)
    npy = TD.NpyMmapSource(dirs[0])
    assert src.spec == ref.spec and repr(src.spec) == repr(ref.spec) == repr(npy.spec)
    assert src.fingerprint() == ref.fingerprint() == npy.fingerprint()
    assert src.mask_chunk_sums().tobytes() == ref.mask_chunk_sums().tobytes() \
        == npy.mask_chunk_sums().tobytes()
    for lo, hi in ((0, 3), (3, 7), (C - 2, C), (1, 2)):
        a, b, c = src.slice_cols(lo, hi), ref.slice_cols(lo, hi), npy.slice_cols(lo, hi)
        assert sorted(a) == sorted(b) == sorted(c)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
            assert a[k].tobytes() == np.ascontiguousarray(c[k]).tobytes(), k
        buf = {k: np.full(shape, 7, dt) for k, (shape, dt) in src.step_slice_like(hi - lo).items()}
        src.read_into(lo, hi, buf)  # what the CUDA prefetcher's staging takes
        assert all(buf[k].tobytes() == a[k].tobytes() for k in a)
        part = src.slice_parts(1, 3, lo, hi)  # what one rank of a group reads
        assert all(part[k].tobytes() == a[k][1:3].tobytes() for k in a)
    assert src.mask_sums_parts(1, 3).tobytes() == src.mask_chunk_sums()[1:3].tobytes()


@pytest.mark.parametrize("case", ["scan-q6", "fused-scalar", "fused-group", "fused-bundle"])
def test_parquet_sessions_bitwise_resident(shards, parts, case, tmp_path):
    q6, q1 = _glas()
    gla = {"q6": q6, "scalar": q6, "group": q1,
           "bundle": T.GLABundle([q6, q1])}[case.split("-")[1]]
    emit = "round" if case.startswith("scan") else "kernel"
    _, _, want = _stepped(gla, TD.InMemorySource(shards), emit)
    d = RD.ParquetSource.save(parts, tmp_path / "pq", row_group_len=GROUP_ROWS)
    src = TD.ParquetSource(d, chunk_len=L, min_chunks=shards["_mask"].shape[1])
    sess = T.Session(T.QuerySpec(gla, rounds=ROUNDS, emit=emit), src, device="cpu")
    got = sess.run()
    assert sess.steps_taken == ROUNDS and sess.io_stats["slices"] == ROUNDS
    assert _same(got.final, want.final)
    assert _same(got.snapshots, want.snapshots)
    assert _same(got.estimates, want.estimates)


def test_ragged_tail_parquet_bitwise(tmp_path):
    """``tests/test_source.py``'s ragged case: rows that fill no chunk
    boundary, ``min_chunks`` past the longest partition, streamed bitwise
    the port's own packing of the same partitions."""
    rows = P * 16 * L - 777
    raw = RT.generate_lineitem(rows, seed=7)
    ragged = [{k: np.asarray(v) for k, v in p.items()} for p in RR.randomize_global(
        {k: jnp.asarray(v) for k, v in raw.items()}, jax.random.key(7), P)]
    packed = TR.pack_partitions(
        [{k: torch.from_numpy(v.copy()) for k, v in p.items()} for p in ragged],
        chunk_len=L, min_chunks=16)
    q6 = T.make_sum_gla(TT.q6_func, TT.q6_cond(TT.Q6_LOW_WINDOW), d_total=float(rows))
    want = T.run_query(T.QuerySpec(q6, rounds=ROUNDS, emit="chunk"), packed, device="cpu")
    src = TD.ParquetSource(TD.ParquetSource.save(ragged, tmp_path / "pq"), chunk_len=L,
                           min_chunks=16)
    assert src.spec.C == 16 and src.fingerprint() == TD.InMemorySource(packed).fingerprint()
    got = T.run_query(T.QuerySpec(q6, rounds=ROUNDS, emit="chunk"), src, device="cpu")
    assert _same(got.final, want.final) and _same(got.snapshots, want.snapshots)


def test_parquet_read_ahead_stays_under_its_budget_plus_one_covering_read(parts, tmp_path):
    d = RD.ParquetSource.save(parts, tmp_path / "pq", row_group_len=GROUP_ROWS)
    budget = 8 * GROUP_ROWS * 28  # 8 groups of 28-byte rows, shared by the P blocks
    src = TD.ParquetSource(d, chunk_len=L, readahead=8, readahead_bytes=budget)
    rows = [p["shipdate"].shape[0] for p in parts]
    row_bytes = 28  # seven 4-byte columns
    blocks_read = set()
    for lo in range(0, src.spec.C, 2):
        hi = min(src.spec.C, lo + 2)
        src.slice_cols(lo, hi)
        cover = 0  # bytes of the row groups covering this slice, every partition
        for n in rows:
            a, b = lo * L, min(hi * L, n)
            if a < b:
                cover += (min(n, -(-b // GROUP_ROWS) * GROUP_ROWS)
                          - a // GROUP_ROWS * GROUP_ROWS) * row_bytes
        cached = sum(v.nbytes for blk in src._block if blk is not None
                     for v in blk[2].values())
        assert cached <= budget + cover, (lo, cached, budget, cover)
        blocks_read.update((i, blk[0]) for i, blk in enumerate(src._block) if blk)
    # the scan read ahead: fewer blocks than slices a partition
    assert len(blocks_read) < P * -(-src.spec.C // 2)


def test_parquet_without_pyarrow_raises_the_reference_message(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError, match="needs the optional 'pyarrow' package"):
        TD.ParquetSource(tmp_path, chunk_len=L)
