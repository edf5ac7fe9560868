"""PyTorch port core (hash dataset, dictionary, probe) against the JAX package.

The same numpy inputs go through ``repro.core`` and ``repro_torch.core``;
every array must be equal (all arithmetic is int32, so no tolerance).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import dictionary as jdict
from repro.core import hash_table as jht
from repro.core import lookup as jlookup
from repro_torch.core import dictionary as tdict
from repro_torch.core import hash_table as tht
from repro_torch.core import lookup as tlookup

SPECIAL_KEYS = [0, 1, 2, 3, -1, -2, -5, 7, 2**31 - 1, -2**31, -0x7FFFFFFF,
                123456789, -987654321, 0x7FFF0000]
TABLE_FIELDS = ("keys", "values", "dup_offsets", "dup_indices",
                "group_count", "n_unique", "n_build", "overflow")


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int32))


def _eq(got: torch.Tensor, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


def test_constants_match():
    assert tht.EMPTY_KEY == int(jht.EMPTY_KEY)
    assert tdict.DICT_PAD == int(jdict.DICT_PAD)
    assert tdict.NO_CODE == int(jdict.NO_CODE)
    assert tlookup.NULL_WORD == int(jlookup.NULL_WORD)


@pytest.mark.parametrize("mode", [tht.HASH_IDENTITY, tht.HASH_FIBONACCI])
@pytest.mark.parametrize("num_buckets", [1, 2, 64, 1 << 15, 1 << 16, 1 << 20])
def test_hash_bucket_matches(mode, num_buckets):
    rng = np.random.default_rng(num_buckets)
    keys = np.concatenate([SPECIAL_KEYS, rng.integers(
        -2**31, 2**31, 2000)]).astype(np.int32)
    _eq(tht.hash_bucket(_t(keys), num_buckets, mode),
        jht.hash_bucket(jnp.asarray(keys), num_buckets, mode))


def test_hash_bucket_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tht.hash_bucket(_t([1]), 8, "crc")


def _build_inputs(case, width):
    """(keys, values, num_buckets) for one build scenario."""
    rng = np.random.default_rng(width)
    if case == "unique":
        keys = rng.choice(4000, 300, replace=False)
        nb = tht.suggest_num_buckets(300, width)
    elif case == "duplicates":
        keys = np.concatenate([rng.integers(0, 60, 400), [-7, -7, 2**31 - 1]])
        nb = tht.suggest_num_buckets(63, width)
    elif case == "overflow":
        keys = rng.choice(1 << 20, 300, replace=False)
        nb = 4  # 4 buckets x width lanes cannot hold 300 keys
    else:
        keys = np.zeros(0)
        nb = 8
    keys = np.asarray(keys, np.int32)
    return keys, rng.permutation(keys.shape[0]).astype(np.int32), nb


@pytest.mark.parametrize("case", ["unique", "duplicates", "overflow",
                                  "empty"])
@pytest.mark.parametrize("mode", [tht.HASH_IDENTITY, tht.HASH_FIBONACCI])
@pytest.mark.parametrize("width", [8, 16])
def test_build_table_matches(case, mode, width):
    keys, vals, nb = _build_inputs(case, width)
    got = tht.build_table(_t(keys), _t(vals), num_buckets=nb,
                          bucket_width=width, hash_mode=mode)
    want = jht.build_table(jnp.asarray(keys), jnp.asarray(vals),
                           num_buckets=nb, bucket_width=width,
                           hash_mode=mode)
    for f in TABLE_FIELDS:
        _eq(getattr(got, f), getattr(want, f), f)
    assert got.hash_mode == want.hash_mode
    assert (got.num_buckets, got.bucket_width) == (nb, width)
    if case == "overflow":
        assert int(got.overflow) > 0


def test_build_table_rejects_non_pow2():
    with pytest.raises(ValueError):
        tht.build_table(_t([1, 2]), _t([0, 1]), num_buckets=6)


@pytest.mark.parametrize("case", ["unique", "duplicates", "overflow"])
def test_table_entries_matches(case):
    keys, vals, nb = _build_inputs(case, 8)
    got = tht.table_entries(tht.build_table(_t(keys), _t(vals),
                                            num_buckets=nb, bucket_width=8))
    want = jht.table_entries(jht.build_table(
        jnp.asarray(keys), jnp.asarray(vals), num_buckets=nb,
        bucket_width=8))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("load", [0.25, 0.5, 0.9])
@pytest.mark.parametrize("n", [0, 1, 100, 2556, 30000])
def test_suggest_num_buckets_matches(n, load):
    assert tht.suggest_num_buckets(n, 8, load) == \
        jht.suggest_num_buckets(n, 8, load)


@pytest.mark.parametrize("capacity_extra", [0, 5])
def test_dictionary_matches(capacity_extra):
    rng = np.random.default_rng(capacity_extra)
    raw = rng.integers(-500, 500, 700).astype(np.int32)
    cap = np.unique(raw).shape[0] + capacity_extra
    got = tdict.build_dictionary(_t(raw), cap)
    want = jdict.build_dictionary(jnp.asarray(raw), cap)
    _eq(got.keys, want.keys)
    _eq(got.n, want.n)
    probes = np.concatenate([raw[:50], [-501, 501, 2**31 - 1, -2**31]]
                            ).astype(np.int32)
    codes = tdict.encode(got, _t(probes))
    _eq(codes, jdict.encode(want, jnp.asarray(probes)))
    np.testing.assert_array_equal(tdict.encode_np(got, probes),
                                  jdict.encode_np(want, probes))
    qcodes = np.array([-1, 0, 3, cap - 1, cap, cap + 9], np.int32)
    _eq(tdict.decode(got, _t(qcodes)), jdict.decode(want,
                                                     jnp.asarray(qcodes)))


def test_dictionary_with_explicit_codes_matches():
    """A dictionary extended by the JAX package carries explicit codes."""
    base = jdict.build_dictionary(jnp.asarray([10, 20, 30], jnp.int32), 3)
    ext, _ = jdict.extend_dictionary(base, np.array([5, 25], np.int32))
    got = tdict.Dictionary(keys=_t(ext.keys), n=_t(ext.n),
                           codes=_t(ext.codes))
    probes = np.array([5, 10, 15, 20, 25, 30, 35], np.int32)
    _eq(tdict.encode(got, _t(probes)), jdict.encode(ext, jnp.asarray(probes)))
    qcodes = np.arange(-1, ext.capacity + 1, dtype=np.int32)
    _eq(tdict.decode(got, _t(qcodes)), jdict.decode(ext, jnp.asarray(qcodes)))


def test_empty_dictionary_matches():
    got = tdict.build_dictionary(_t([]), 4)
    want = jdict.build_dictionary(jnp.zeros((0,), jnp.int32), 4)
    _eq(got.keys, want.keys)
    _eq(tdict.encode(got, _t([1, 2])), jdict.encode(want, jnp.asarray(
        [1, 2], jnp.int32)))


@pytest.mark.parametrize("case", ["unique", "duplicates", "overflow"])
@pytest.mark.parametrize("mode", [tht.HASH_IDENTITY, tht.HASH_FIBONACCI])
@pytest.mark.parametrize("width", [8, 16])
def test_probe_matches(case, mode, width):
    keys, vals, nb = _build_inputs(case, width)
    rng = np.random.default_rng(1)
    probes = np.concatenate([rng.choice(keys, 200), rng.integers(
        -5000, 5000, 200), [tht.EMPTY_KEY]]).astype(np.int32)
    got = tlookup.probe(tht.build_table(_t(keys), _t(vals), num_buckets=nb,
                                        bucket_width=width, hash_mode=mode),
                        _t(probes))
    want = jlookup.probe(jht.build_table(jnp.asarray(keys), jnp.asarray(vals),
                                         num_buckets=nb, bucket_width=width,
                                         hash_mode=mode), jnp.asarray(probes))
    for g, w, f in zip(got, want, got._fields):
        _eq(g, w, f)
    _eq(tlookup.pack_words(got), jlookup.pack_words(want))
    words = tlookup.pack_words(got)
    for g, w in zip(tlookup.unpack_words(words),
                    jlookup.unpack_words(jnp.asarray(words.numpy()))):
        _eq(g, w)
