"""Port parity for the fused-aggregate kernels (``repro_torch.kernels``).

On the CPU the wrappers run their plain versions (``kernels/ref.py``); these
are held against the reference's Pallas kernels in interpret mode
(``repro.kernels.fused_agg``) on the same shards and the same carry.  The
CUDA kernels are held against the plain versions by the ``gpu`` tests,
which skip without a card (``chip_smoke.py`` runs the same checks at the
main path's shapes); they live in test_torch_kernels_gpu.py, which imports
no JAX so that it runs on a machine with a card.

Tolerances: counters (``scanned``, ``matched``) exact; f32 sums
rtol=1e-5 with atol=1e-5·max|ref| — the summation order differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gla as RG
from repro.core import randomize as RR
from repro.data import tpch as RT
from repro.kernels import fused_agg as RFK
from repro_torch import convert
from repro_torch import gla as TG
from repro_torch.data import tpch as TT
from repro_torch.kernels import fused_agg as FK
from repro_torch.kernels import ref

P, C, L = 4, 8, 256
ROWS = P * C * L
RTOL = 1e-5


@pytest.fixture(scope="module")
def shards():
    raw = RT.generate_lineitem(ROWS, seed=21)
    parts = RR.randomize_global({k: jnp.asarray(v) for k, v in raw.items()},
                                jax.random.key(5), P)
    return {k: np.asarray(v)
            for k, v in RR.pack_partitions(parts, chunk_len=L).items()}


def _pair(name):
    d = float(ROWS)
    if name == "q6-low":
        return (RG.make_sum_gla(RT.q6_func, RT.q6_cond(RT.Q6_LOW_WINDOW), d_total=d),
                TG.make_sum_gla(TT.q6_func, TT.q6_cond(TT.Q6_LOW_WINDOW), d_total=d))
    if name == "q1-scalar":
        return (RG.make_sum_gla(RT.q1_func, RT.q1_cond, d_total=d, num_aggs=4),
                TG.make_sum_gla(TT.q1_func, TT.q1_cond, d_total=d, num_aggs=4))
    if name == "q1-small":
        return (RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_small,
                                    num_groups=4, d_total=d, num_aggs=4),
                TG.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_small,
                                    num_groups=4, d_total=d, num_aggs=4))
    assert name == "q1-bucketed"
    kw = dict(num_groups=1000, bucket_bits=7, d_total=d, num_aggs=4)
    return (RG.make_groupby_gla(RT.q1_func, RT.q1_cond, RT.q1_group_large, **kw),
            TG.make_groupby_gla(TT.q1_func, TT.q1_cond, TT.q1_group_large, **kw))


def _assert_state(got, want):
    """Port SumState vs reference SumState (numpy leaves, same shapes)."""
    for f in ("scanned", "matched"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("sum", "sumsq"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(),
                                   err_msg=f)


def _ref_states(rgla, shards, lo, hi, carry_hi):
    """Reference interpret-mode K1: per partition, carry over [0, carry_hi)
    then one step over [lo, hi).  Returns (carries, advanced), stacked."""
    carries, outs = [], []
    for p in range(P):
        cols = {k: jnp.asarray(v[p]) for k, v in shards.items()}
        st = rgla.init()
        if carry_hi:
            st = RFK.fused_round_step(rgla, st, {k: v[:carry_hi] for k, v in cols.items()},
                                      interpret=True)
        carries.append(st)
        outs.append(RFK.fused_round_step(rgla, st, {k: v[lo:hi] for k, v in cols.items()},
                                         interpret=True))

    def stack(states):
        return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *states)

    return stack(carries), stack(outs)


@pytest.mark.parametrize("query", ["q6-low", "q1-scalar", "q1-small", "q1-bucketed"])
def test_round_step_matches_reference_interpret(shards, query):
    """K1 from the same mid-scan carry: the port starts from the reference's
    state (``convert.state_from_reference``) and both advance one round."""
    rgla, tgla = _pair(query)
    carry, want = _ref_states(rgla, shards, 4, 8, carry_hi=4)
    state = convert.state_from_reference(carry, device="cpu")
    cols = convert.shards_from_reference({k: v[:, 4:8] for k, v in shards.items()},
                                         device="cpu")
    before = FK.launch_counts()
    got = FK.fused_round_step(tgla, state, cols)
    assert FK.launch_counts() == before  # the CPU route launches nothing
    _assert_state(got, want)


def test_prefix_states_match_reference_interpret(shards):
    rgla, tgla = _pair("q6-low")
    finals, prefixes = [], []
    for p in range(P):
        f, pre = RFK.fused_prefix_states(
            rgla, {k: jnp.asarray(v[p]) for k, v in shards.items()}, interpret=True)
        finals.append(f)
        prefixes.append(pre)

    def stack(states):
        return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *states)

    f_t, pre_t = FK.fused_prefix_states(
        tgla, convert.shards_from_reference(shards, device="cpu"))
    _assert_state(f_t, stack(finals))
    _assert_state(pre_t, stack(prefixes))
    assert pre_t.sum.shape == (P, C + 1, 1)


def _random_inputs(seed, A=3, G=37, Cn=5, Ln=100):
    g = torch.Generator().manual_seed(seed)
    vals = torch.rand((P, Cn, Ln, A), generator=g) * 100
    w = (torch.rand((P, Cn, Ln), generator=g) < 0.4).float()
    gids = torch.randint(-2, G + 2, (P, Cn, Ln), generator=g, dtype=torch.int32)
    carry = torch.cat([torch.rand((P, 2 * A), generator=g),
                       torch.randint(0, 9, (P, 1), generator=g).float()], 1)
    cs, cq = torch.rand((P, G, A), generator=g), torch.rand((P, G, A), generator=g)
    cm = torch.randint(0, 9, (P, G), generator=g).float()
    return vals, w, gids, carry, cs, cq, cm


def test_plain_prefix_is_the_round_step_fold():
    """K2's last running value is K1's fold from a zero carry, bit for bit;
    out-of-range group ids drop out, as in segment_sum."""
    vals, w, gids, carry, cs, cq, cm = _random_inputs(0)
    pre = ref.scalar_prefix(vals, w)
    zero = torch.zeros_like(carry)
    assert torch.equal(pre[:, -1], ref.scalar_round_step(vals, w, zero))
    s, q, m = ref.group_round_step(vals, w, gids, cs, cq, cm)
    G = cs.shape[1]
    keep = ((gids >= 0) & (gids < G)).float()
    assert torch.equal(m.sum(1) - cm.sum(1), (w * keep).sum((1, 2)))


def test_group_step_adds_each_chunk_total_to_the_carry():
    """Each chunk's per-group sums are formed from zero and added to the
    carry once, as the reference adds its segment sums to the state: rows
    added one by one onto a carry of 2**24 would each round away."""
    Pn, Cn, Ln, G = 2, 3, 64, 2
    big = float(2 ** 24)
    vals, w = torch.ones((Pn, Cn, Ln, 1)), torch.ones((Pn, Cn, Ln))
    gids = torch.zeros((Pn, Cn, Ln), dtype=torch.int32)
    cs, cq = torch.full((Pn, G, 1), big), torch.full((Pn, G, 1), big)
    s, q, m = FK.group_round_step(vals, w, gids, cs, cq, torch.full((Pn, G), big))
    want = torch.tensor([big + Cn * Ln, big]).expand(Pn, G)
    for x in (s[..., 0], q[..., 0], m):
        assert torch.equal(x, want)


def test_wrappers_check_their_inputs():
    vals, w, gids, carry, cs, cq, cm = _random_inputs(1)
    with pytest.raises(ValueError, match="dtype"):
        FK.scalar_round_step(vals.double(), w, carry)
    with pytest.raises(ValueError, match="shape"):
        FK.scalar_round_step(vals, w[:, :1], carry)
    with pytest.raises(ValueError, match="contiguous"):
        FK.scalar_prefix(vals, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="dtype"):
        FK.group_round_step(vals, w, gids.long(), cs, cq, cm)
    with pytest.raises(ValueError, match="no kernel for device"):
        FK.scalar_prefix(vals.to("meta"), w.to("meta"))
