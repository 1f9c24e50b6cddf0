"""Port parity for column encodings (``repro_torch.data.encodings``) and the
plain route of K1's decode stage (``repro_torch.kernels.decode``).

The same numpy columns go through both packages: ``encode_array`` must give
byte-identical physical arrays, ``dict_encoding_for`` equal encodings, and
``decode_block``/``decode_cols`` bit-identical logical values (the decode is
exact).  The CUDA kernel ``pf_decode`` is held against this plain route by
``test_torch_kernels_gpu.py`` on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data import encodings as RE
from repro_torch.data import encodings as TE
from repro_torch.kernels import decode as TD

WIDTHS = [1, 2, 4, 8, 16]


def _ref_enc(enc):
    """The reference's encoding with the port's fields."""
    if isinstance(enc, TE.DictEncoding):
        return RE.DictEncoding(*enc)
    return RE.BitPackedEncoding(*enc)


def _dict_column(n_values, shape, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    values = np.unique(rng.normal(size=4 * n_values).astype(dtype))[:n_values]
    assert values.size == n_values
    return rng.choice(values, size=shape)


@pytest.mark.parametrize("n_values,code", [(11, "int8"), (128, "int8"),
                                           (129, "int16"), (5000, "int16")])
def test_dict_encoding_matches_reference_bytes(n_values, code):
    a = _dict_column(n_values, (3, 4, 256), seed=n_values)
    enc = TE.dict_encoding_for(a)
    ref = RE.dict_encoding_for(a)
    assert enc == ref and enc.code_dtype == code
    phys = TE.encode_array(a, enc)
    assert phys.dtype == np.dtype(code)
    assert phys.tobytes() == RE.encode_array(a, ref).tobytes()


@pytest.mark.parametrize("bits", WIDTHS)
def test_bitpacked_encoding_matches_reference_bytes(bits):
    rng = np.random.default_rng(bits)
    a = rng.integers(0, 1 << bits, size=(2, 3, 128), dtype=np.int32)
    enc = TE.BitPackedEncoding(bits)
    phys = TE.encode_array(a, enc)
    assert phys.shape == (2, 3, 128 // enc.lanes) and phys.dtype == np.int32
    assert phys.tobytes() == RE.encode_array(a, _ref_enc(enc)).tobytes()


@pytest.mark.parametrize("case", ["dict-int8", "dict-int16", "dict-of-int16",
                                  *(f"bits-{b}" for b in WIDTHS)])
def test_decode_block_bitwise_vs_reference(case):
    if case == "dict-of-int16":  # a 2-byte logical dtype
        a = np.random.default_rng(9).integers(-900, 900, (4, 5, 128)).astype(np.int16)
        enc = TE.dict_encoding_for(a)
    elif case.startswith("dict"):
        n = {"dict-int8": 11, "dict-int16": 700}[case]
        a = _dict_column(n, (4, 5, 128), seed=len(case))
        enc = TE.dict_encoding_for(a)
    else:
        bits = int(case.split("-")[1])
        a = np.random.default_rng(bits).integers(0, 1 << bits, (4, 5, 128),
                                                  dtype=np.int32)
        enc = TE.BitPackedEncoding(bits)
    phys = TE.encode_array(a, enc)
    got = TE.decode_block(torch.from_numpy(phys), enc).numpy()
    want = np.asarray(RE.decode_block(jnp.asarray(phys), _ref_enc(enc)))
    assert got.dtype == want.dtype == a.dtype
    assert got.tobytes() == want.tobytes() == a.tobytes()


def test_bitpacked_decode_casts_to_logical_dtype():
    a = np.random.default_rng(0).integers(0, 16, (2, 64), dtype=np.int16)
    enc = TE.BitPackedEncoding(4, logical_dtype="int16")
    phys = TE.encode_array(a, enc)
    got = TE.decode_block(torch.from_numpy(phys), enc)
    want = np.asarray(RE.decode_block(jnp.asarray(phys), _ref_enc(enc)))
    assert got.dtype == torch.int16
    assert got.numpy().tobytes() == want.tobytes() == a.tobytes()


def test_decode_cols_matches_reference_and_passes_plain_columns():
    rng = np.random.default_rng(3)
    disc = rng.integers(0, 11, (4, 6, 128)).astype(np.float32) / np.float32(100)
    sd = rng.integers(0, 2526, (4, 6, 128), dtype=np.int32)
    ep = rng.uniform(1, 1e5, (4, 6, 128)).astype(np.float32)
    encs = {"discount": TE.dict_encoding_for(disc),
            "shipdate": TE.BitPackedEncoding(12)}
    phys = {"discount": TE.encode_array(disc, encs["discount"]),
            "shipdate": TE.encode_array(sd, encs["shipdate"]), "extendedprice": ep}
    norm = TE.normalize_encodings(encs)
    assert norm == RE.normalize_encodings({k: _ref_enc(e) for k, e in encs.items()})
    got = TE.decode_cols({k: torch.from_numpy(v) for k, v in phys.items()}, norm)
    want = RE.decode_cols({k: jnp.asarray(v) for k, v in phys.items()},
                          tuple((k, _ref_enc(e)) for k, e in norm))
    assert list(got) == list(phys)
    for k in phys:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k
    assert got["extendedprice"].data_ptr() == phys["extendedprice"].ctypes.data
    assert TE.decode_cols({"x": torch.ones(3)}, norm)["x"].tolist() == [1, 1, 1]


def test_encode_array_validates_like_the_reference():
    with pytest.raises(ValueError, match="outside the dictionary"):
        TE.encode_array(np.array([1.0, 2.5], np.float32),
                        TE.DictEncoding((1.0, 2.0)))
    with pytest.raises(ValueError, match="integer column"):
        TE.encode_array(np.ones(32, np.float32), TE.BitPackedEncoding(4))
    with pytest.raises(ValueError, match="outside"):
        TE.encode_array(np.full(32, 16, np.int32), TE.BitPackedEncoding(4))
    with pytest.raises(ValueError, match="multiple of 8 lanes"):
        TE.encode_array(np.ones(12, np.int32), TE.BitPackedEncoding(4))


def test_decode_wrapper_checks_its_inputs():
    enc = TE.DictEncoding((0.5, 1.5))
    with pytest.raises(ValueError, match="dtype"):
        TD.decode([(torch.zeros(4, dtype=torch.int32), enc)])
    with pytest.raises(ValueError, match="int8/int16"):
        TD.decode([(torch.zeros(4, dtype=torch.int32),
                    TE.DictEncoding((0.5,), code_dtype="int32"))])
    with pytest.raises(ValueError, match="bit width"):
        TD.decode([(torch.zeros(4, dtype=torch.int32), TE.BitPackedEncoding(0))])
    assert TD.decode([]) == []


def test_decode_clamps_codes_to_the_table():
    """Codes outside the table (never written by encode_array) read its
    ends, as pf_decode does, instead of reading out of bounds."""
    enc = TE.DictEncoding((0.25, 0.5, 0.75))
    codes = torch.tensor([-3, 0, 2, 7], dtype=torch.int8)
    assert TE.decode_block(codes, enc).tolist() == [0.25, 0.25, 0.75, 0.75]


@settings(max_examples=25, deadline=None, database=None)
@given(st.integers(min_value=0, max_value=4), st.integers(min_value=1, max_value=6),
       st.integers(min_value=0, max_value=2**31 - 1))
def test_roundtrip_property(width_idx, blocks, seed):
    """encode -> decode is the identity, and the physical bytes are the
    reference's, for random bit widths and dictionary sizes."""
    rng = np.random.default_rng(seed)
    bits = WIDTHS[width_idx]
    a = rng.integers(0, 1 << bits, (2, blocks * 32), dtype=np.int32)
    enc = TE.BitPackedEncoding(bits)
    phys = TE.encode_array(a, enc)
    assert phys.tobytes() == RE.encode_array(a, _ref_enc(enc)).tobytes()
    assert TE.decode_block(torch.from_numpy(phys), enc).numpy().tobytes() == a.tobytes()
    d = rng.choice(rng.normal(size=1 + seed % 300).astype(np.float32), (3, blocks))
    denc = TE.dict_encoding_for(d)
    dphys = TE.encode_array(d, denc)
    assert dphys.tobytes() == RE.encode_array(d, _ref_enc(denc)).tobytes()
    assert TE.decode_block(torch.from_numpy(dphys), denc).numpy().tobytes() == d.tobytes()
