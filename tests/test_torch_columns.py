"""The port's columnar formats against the JAX package: the bucket ladder,
dictionary codes, host conversion and the numpy-parts bridge."""

import numpy as np
import pytest
import torch

from oceanbase_tpu.analysis.poison import poison_pad_lanes, results_identical
from oceanbase_tpu.datatypes import SqlType as JSqlType
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch import bridge
from oceanbase_tpu_torch.datatypes import SqlType
from oceanbase_tpu_torch.vector import column as tcol


def jax_parts(rel):
    """A JAX Relation as the bridge's numpy parts, every lane kept."""
    parts = {}
    for name, c in rel.columns.items():
        parts[name] = (
            np.asarray(c.data),
            None if c.valid is None else np.asarray(c.valid),
            (c.dtype.kind.value, c.dtype.precision, c.dtype.scale),
            None if c.sdict is None else c.sdict.values)
    return parts, None if rel.mask is None else np.asarray(rel.mask)


def _sample_arrays(n, seed=3):
    rng = np.random.default_rng(seed)
    words = np.array(["PROMO BRUSHED TIN", "STANDARD PLATED", "ECONOMY",
                      "", "promo", "LARGE POLISHED NICKEL"], dtype=object)
    arrays = {
        "i": rng.integers(-1000, 1000, n),
        "dec": rng.integers(-99999, 99999, n),
        "d": rng.integers(8000, 11000, n).astype(np.int32),
        "s": words[rng.integers(0, len(words), n)],
        "f": rng.normal(size=n),
        "b": rng.random(n) < 0.5,
    }
    valids = {"i": rng.random(n) < 0.8, "s": rng.random(n) < 0.9}
    return arrays, valids


def _types(mod):
    return {"dec": mod.SqlType.decimal(15, 2), "d": mod.SqlType.date()}


@pytest.mark.parametrize("n,floor,growth", [
    (0, 64, 2.0), (1, 64, 2.0), (64, 64, 2.0), (65, 64, 2.0),
    (1000, 64, 2.0), (6_001_215, 64, 2.0), (100, 8, 1.5), (77, 1, 1.0),
])
def test_bucket_capacity_matches(n, floor, growth):
    assert tcol.bucket_capacity(n, floor, growth) == \
        jcol.bucket_capacity(n, floor, growth)


def test_string_dict_codes_match():
    rng = np.random.default_rng(11)
    vocab = np.array([f"w{i:03d}" for i in range(50)] + ["", "Z", "a b"],
                     dtype=object)
    strings = vocab[rng.integers(0, len(vocab), 2000)]
    tcodes, tdict = tcol.StringDict.encode(strings)
    jcodes, jdict = jcol.StringDict.encode(strings)
    assert tcodes.dtype == jcodes.dtype == np.int32
    np.testing.assert_array_equal(tcodes, jcodes)
    np.testing.assert_array_equal(tdict.values, jdict.values)
    assert hash(tdict) == hash(jdict)
    for s in ["w010", "nope", "", "Z", "zz"]:
        assert tdict.code_of(s) == jdict.code_of(s)
        assert tdict.lower_bound(s) == jdict.lower_bound(s)


@pytest.mark.parametrize("limit", [None, 7])
def test_from_numpy_to_numpy_match(limit):
    arrays, valids = _sample_arrays(200)
    trel = tcol.from_numpy(arrays, types=_types(tcol), valids=valids,
                           device="cpu")
    jrel = jcol.from_numpy(arrays, types=_types(jcol), valids=valids)
    for name, c in trel.columns.items():
        jc = jrel.columns[name]
        assert c.dtype.kind.value == jc.dtype.kind.value
        assert str(c.data.numpy().dtype) == str(np.asarray(jc.data).dtype)
    ok, why = results_identical(tcol.to_numpy(trel, limit),
                                jcol.to_numpy(jrel, limit))
    assert ok, why


def test_to_numpy_drops_dead_lanes():
    arrays, valids = _sample_arrays(100)
    jrel = jcol.from_numpy(arrays, types=_types(jcol), valids=valids)
    jrel = poison_pad_lanes(jrel.pad_to(jcol.bucket_capacity(101)))
    parts, mask = jax_parts(jrel)
    trel = bridge.relation_from_parts(parts, mask, device="cpu")
    ok, why = results_identical(tcol.to_numpy(trel), jcol.to_numpy(jrel))
    assert ok, why


def test_bridge_round_trip_is_bit_identical():
    arrays, valids = _sample_arrays(300, seed=5)
    jrel = jcol.from_numpy(arrays, types=_types(jcol), valids=valids)
    jrel = poison_pad_lanes(jrel.pad_to(jcol.bucket_capacity(301)))
    parts, mask = jax_parts(jrel)
    trel = bridge.relation_from_parts(parts, mask, device="cpu")
    back, bmask = bridge.relation_to_parts(trel)
    np.testing.assert_array_equal(bmask, mask)
    assert sorted(back) == sorted(parts)
    for name, (data, valid, t, dvals) in parts.items():
        bdata, bvalid, bt, bdvals = back[name]
        assert bdata.dtype == data.dtype
        assert bdata.tobytes() == data.tobytes()
        assert (bvalid is None) == (valid is None)
        if valid is not None:
            np.testing.assert_array_equal(bvalid, valid)
        assert bt == t
        if dvals is not None:
            np.testing.assert_array_equal(bdvals, dvals)


def test_pad_to_matches():
    arrays, valids = _sample_arrays(70)
    trel = tcol.from_numpy(arrays, types=_types(tcol), valids=valids,
                           device="cpu").pad_to(128)
    jrel = jcol.from_numpy(arrays, types=_types(jcol),
                           valids=valids).pad_to(128)
    tparts, tmask = bridge.relation_to_parts(trel)
    jparts, jmask = jax_parts(jrel)
    np.testing.assert_array_equal(tmask, jmask)
    for name in jparts:
        np.testing.assert_array_equal(tparts[name][0], jparts[name][0])
        if jparts[name][1] is not None:
            np.testing.assert_array_equal(tparts[name][1], jparts[name][1])


def test_empty_relation_matches():
    types = {"a": SqlType.int_(), "s": SqlType.string(),
             "d": SqlType.decimal(15, 2)}
    jtypes = {"a": JSqlType.int_(), "s": JSqlType.string(),
              "d": JSqlType.decimal(15, 2)}
    trel = tcol.empty_relation(types, device="cpu")
    jrel = jcol.empty_relation(jtypes)
    assert trel.capacity == jrel.capacity == 1
    assert int(trel.count()) == int(jrel.count()) == 0
    ok, why = results_identical(tcol.to_numpy(trel), jcol.to_numpy(jrel))
    assert ok, why


def test_gather_clips_like_jax():
    arrays, valids = _sample_arrays(10)
    trel = tcol.from_numpy(arrays, types=_types(tcol), valids=valids,
                           device="cpu")
    jrel = jcol.from_numpy(arrays, types=_types(jcol), valids=valids)
    idx = np.array([-5, 0, 3, 9, 10, 1000])
    tg = trel.gather(torch.from_numpy(idx))
    jg = jrel.gather(idx)
    for name in arrays:
        np.testing.assert_array_equal(tg.columns[name].data.numpy(),
                                      np.asarray(jg.columns[name].data))
