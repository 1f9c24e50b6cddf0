"""Port parity for the paper's two-stage distributed randomization
(``repro_torch.randomize.randomize_distributed``, paper §4.2) against
``repro/core/randomize.py``.

The port draws from a ``torch.Generator``, the reference from
``jax.random``, so the two are held to each other by multiset (every
column's sorted output equal to the other's, bitwise, with the same names
and dtypes) and to the algorithm statistically, at fixed seeds with 6σ
limits: bucket sizes around N/P (σ² = N·(1/P)(1−1/P)); each origin's count
in a target's first round-slice around its expectation (σ² of a binomial
draw of that slice); and the number of adjacent pairs of rows from one
origin around the (n−1)·Σ pᵢ² that a random order gives.  Also the
reference's three dtype cases (``tests/test_randomize.py``): an empty
bucket and an origin without rows keep int32 and float32, and the result
packs into the engine layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import randomize as RR
from repro.data import tpch as RT
from repro_torch import randomize as TR

SIGMAS = 6.0


def _tiny_parts():
    return [{"shipdate": torch.arange(3, dtype=torch.int32),
             "extendedprice": torch.tensor([1.5, 2.5, 3.5], dtype=torch.float32)},
            {"shipdate": torch.arange(4, dtype=torch.int32),
             "extendedprice": torch.tensor([4.5, 5.5, 6.5, 7.5], dtype=torch.float32)}]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _empty_bucket_seed():
    """The first seed at which one of the two targets receives no row of the
    seven (chance 1/64 a seed), asserted so a change of the draws cannot
    turn the case into one without an empty bucket."""
    for seed in range(1000):
        out = TR.randomize_distributed(_tiny_parts(), _gen(seed))
        if 0 in [o["shipdate"].shape[0] for o in out]:
            return seed
    raise AssertionError("no seed of 1000 leaves a target empty")


def test_empty_bucket_preserves_dtype():
    out = TR.randomize_distributed(_tiny_parts(), _gen(_empty_bucket_seed()))
    sizes = [o["shipdate"].shape[0] for o in out]
    assert 0 in sizes and sum(sizes) == 7
    for o in out:
        assert o["shipdate"].dtype == torch.int32
        assert o["extendedprice"].dtype == torch.float32


def test_zero_row_source_partition_preserves_dtype():
    parts = [{"shipdate": torch.zeros((0,), dtype=torch.int32)},
             {"shipdate": torch.arange(4, dtype=torch.int32)}]
    out = TR.randomize_distributed(parts, _gen(0))
    assert all(o["shipdate"].dtype == torch.int32 for o in out)
    assert sum(o["shipdate"].shape[0] for o in out) == 4


def test_columns_off_the_generators_device_are_refused():
    """The draws and the exchange run on the generator's device and copy
    nothing: a column elsewhere (here on ``meta``, as a CUDA column beside
    the default CPU generator would be) is refused before any draw."""
    parts = _tiny_parts()
    parts[1]["extendedprice"] = parts[1]["extendedprice"].to("meta")
    gen = _gen(0)
    state = gen.get_state()
    with pytest.raises(ValueError, match="'extendedprice' of origin 1 lives on meta"):
        TR.randomize_distributed(parts, gen)
    assert torch.equal(gen.get_state(), state)


def test_empty_bucket_packs_into_engine_layout():
    out = TR.randomize_distributed(_tiny_parts(), _gen(_empty_bucket_seed()))
    shards = TR.pack_partitions(out, chunk_len=4)
    assert shards["shipdate"].dtype == torch.int32
    assert shards["extendedprice"].dtype == torch.float32
    dead = int(shards["_mask"].sum(dim=(1, 2)).argmin())
    assert shards["_mask"][dead].sum() == 0
    # the live rows are the targets' rows, in order, at the head of each
    for o, row in zip(out, shards["shipdate"].reshape(len(out), -1)):
        assert torch.equal(row[:o["shipdate"].shape[0]], o["shipdate"])


def _clustered(rows, P, seed):
    """Lineitem sorted by shipdate (the clustered order randomization
    breaks), split into P contiguous origins, each with an ``origin`` tag."""
    cols = RT.generate_lineitem(rows, seed=seed)
    order = np.argsort(cols["shipdate"], kind="stable")
    cols = {k: v[order] for k, v in cols.items()}
    bounds = np.linspace(0, rows, P + 1).astype(int)
    parts = []
    for i in range(P):
        part = {k: v[bounds[i]:bounds[i + 1]] for k, v in cols.items()}
        part["origin"] = np.full(bounds[i + 1] - bounds[i], i, np.int32)
        parts.append(part)
    return parts


def test_port_and_reference_outputs_are_one_multiset():
    parts = _clustered(20_000, 4, seed=3)
    ref = RR.randomize_distributed([{k: jnp.asarray(v) for k, v in p.items()} for p in parts],
                                   jax.random.key(5))
    got = TR.randomize_distributed([{k: torch.from_numpy(v.copy()) for k, v in p.items()}
                                    for p in parts], _gen(5))
    assert len(got) == len(ref) == 4
    for o, r in zip(got, ref):
        assert list(o) == list(r)
        assert all(str(o[k].dtype).removeprefix("torch.") == np.asarray(r[k]).dtype.name
                   for k in o)
    for k in parts[0]:
        a = np.sort(torch.cat([o[k] for o in got]).numpy())
        b = np.sort(np.concatenate([np.asarray(r[k]) for r in ref]))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.fixture(scope="module")
def shuffled():
    P = 8
    parts = _clustered(400_000, P, seed=7)
    tparts = [{k: torch.from_numpy(v.copy()) for k, v in p.items()} for p in parts]
    return P, parts, TR.randomize_distributed(tparts, _gen(11))


def test_bucket_sizes_within_six_sigma_of_n_over_p(shuffled):
    P, parts, out = shuffled
    N = sum(p["origin"].shape[0] for p in parts)
    sigma = np.sqrt(N * (1 / P) * (1 - 1 / P))
    sizes = np.array([o["origin"].shape[0] for o in out])
    assert sizes.sum() == N
    assert np.all(np.abs(sizes - N / P) <= SIGMAS * sigma), sizes


def test_origin_mix_of_each_first_round_slice_within_six_sigma(shuffled):
    """Each target's first round-slice (1/16 of its rows, as a 16-round
    session reads it) holds each origin's share of the data."""
    P, parts, out = shuffled
    N = sum(p["origin"].shape[0] for p in parts)
    share = np.array([p["origin"].shape[0] for p in parts]) / N
    for j, o in enumerate(out):
        n = o["origin"].shape[0] // 16
        counts = np.bincount(o["origin"][:n].numpy(), minlength=P)
        sigma = np.sqrt(n * share * (1 - share))
        assert np.all(np.abs(counts - n * share) <= SIGMAS * sigma), (j, counts)


def test_stage_two_separates_the_rows_of_one_origin(shuffled):
    """Adjacent rows of one target come from one origin as often as in a
    random order, (n−1)·Σ pᵢ², not in runs: a target receives its rows
    origin by origin, all but P−1 of its adjacent pairs from one origin,
    until stage 2 permutes them."""
    P, _, out = shuffled
    for j, o in enumerate(out):
        org = o["origin"].numpy()
        n = org.shape[0]
        p = np.bincount(org, minlength=P) / n
        q = float((p ** 2).sum())
        same = int((org[1:] == org[:-1]).sum())
        sigma = np.sqrt((n - 1) * q * (1 - q))
        assert abs(same - (n - 1) * q) <= SIGMAS * sigma, (j, same, (n - 1) * q)


def test_each_origin_keeps_its_rows_and_each_row_its_columns(shuffled):
    """The exchange moves whole rows: every (origin, row) pair comes out
    once, with every column of that row."""
    P, parts, out = shuffled
    cat = {k: torch.cat([o[k] for o in out]).numpy() for k in parts[0]}
    src = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    key_out = np.lexsort([cat[k].view(np.uint32) for k in sorted(cat)])
    key_src = np.lexsort([src[k].view(np.uint32) for k in sorted(src)])
    for k in src:
        assert cat[k][key_out].tobytes() == src[k][key_src].tobytes(), k


def test_a_ragged_result_packs_with_min_chunks_at_a_multiple_of_the_rounds(shuffled):
    _, _, out = shuffled
    L, rounds = 256, 16
    C = max(-(-o["origin"].shape[0] // L) for o in out)
    packed = TR.pack_partitions(out, chunk_len=L, min_chunks=-(-C // rounds) * rounds)
    assert packed["_mask"].shape[1] % rounds == 0 and packed["_mask"].shape[1] >= C
    assert packed["origin"].dtype == torch.int32
    assert packed["_mask"].sum(dim=(1, 2)).tolist() == [float(o["origin"].shape[0])
                                                        for o in out]
