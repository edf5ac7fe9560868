"""The port's dedup, window mask and skew statistics against the JAX package.

Same numpy inputs through ``repro.core.dedup`` / ``repro.core.skew`` and
their ``repro_torch`` counterparts; all integer results must be equal and
the float statistics equal with ``==`` (the same numpy lines on the same
counts).  ``coalesce_window_mask`` is held against both the JAX oracle and
the Pallas kernel in interpret mode on the streams of
``tests/test_kernels.py``; on the CPU the port's wrapper takes its plain
version, and the CUDA kernel is held against that on the card by
``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import dedup as jdedup
from repro.core import skew as jskew
from repro.kernels.coalesce_window import \
    coalesce_window_mask as jcoalesce_window_mask
from repro_torch.core import dedup as tdedup
from repro_torch.core import skew as tskew
from repro_torch.kernels import coalesce_window_mask

ZIPF_S = (0.0, 0.5, 1.5, 2.0)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


def _stream(kind: str) -> np.ndarray:
    rng = np.random.default_rng(17)
    if kind == "dup_heavy":
        return rng.integers(0, 12, 300).astype(np.int32)
    if kind == "wide":
        return rng.integers(-50, 50, 257).astype(np.int32)
    if kind == "zipf":
        return tskew.zipf_sample(400, 2_000, 1.5, seed=3)
    return np.array([5], np.int32)  # single


@pytest.mark.parametrize("kind", ["dup_heavy", "wide", "zipf", "single"])
@pytest.mark.parametrize("cap", ["exact", "roomy", "overflow"])
def test_coalesce_matches_jax(kind, cap):
    keys = _stream(kind)
    distinct = len(np.unique(keys))
    capacity = {"exact": distinct, "roomy": keys.size,
                "overflow": max(1, distinct // 2)}[cap]
    got = tdedup.coalesce(torch.as_tensor(keys), capacity, pad=-7)
    want = jdedup.coalesce(jnp.asarray(keys), capacity, pad=-7)
    for f in got._fields:
        _eq(getattr(got, f), getattr(want, f), f)
    assert got.inverse.dtype == got.unique.dtype == torch.int32
    if cap != "overflow":
        _eq(tdedup.scatter_back(got.unique, got.inverse), keys)


def test_scatter_back_trailing_dims_match_jax():
    keys = _stream("dup_heavy")
    co = tdedup.coalesce(torch.as_tensor(keys), keys.size)
    res = torch.stack([co.unique * 2, co.unique + 1], dim=1)
    jco = jdedup.coalesce(jnp.asarray(keys), keys.size)
    jres = jnp.stack([jco.unique * 2, jco.unique + 1], axis=1)
    _eq(tdedup.scatter_back(res, co.inverse),
        jdedup.scatter_back(jres, jco.inverse))


@pytest.mark.parametrize("kind", ["dup_heavy", "wide", "zipf"])
def test_duplication_factor_matches_jax(kind):
    keys = _stream(kind)
    got = tdedup.duplication_factor(torch.as_tensor(keys))
    want = jdedup.duplication_factor(jnp.asarray(keys))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


@pytest.mark.parametrize("window", [2, 4, 8])
@pytest.mark.parametrize("m,block", [(16, 8), (100, 32), (257, 64)])
def test_window_mask_matches_oracle_and_pallas(window, m, block):
    """The streams of ``test_kernels.py``: keys 0..11, so none is a
    sentinel and every stream is longer than ``window - 1``."""
    rng = np.random.default_rng(m + window)
    keys = rng.choice(12, m).astype(np.int32)
    got = coalesce_window_mask(torch.as_tensor(keys), window=window)
    _eq(got, jdedup.windowed_coalesce_mask(jnp.asarray(keys), window=window))
    _eq(got, jcoalesce_window_mask(jnp.asarray(keys), window=window,
                                   block=block, interpret=True))
    _eq(tdedup.windowed_coalesce_mask(torch.as_tensor(keys), window), got)


@pytest.mark.parametrize("s", [0.5, 1.5, 2.0])
def test_window_mask_zipf_streams_match_jax(s):
    keys = tskew.zipf_sample(200, 1000, s, seed=int(s * 10) + 1000)
    got = coalesce_window_mask(torch.as_tensor(keys))
    want = jdedup.windowed_coalesce_mask(jnp.asarray(keys), window=8)
    _eq(got, want)
    _eq(got, jcoalesce_window_mask(jnp.asarray(keys), window=8, block=256,
                                   interpret=True))
    if s >= 1.5:
        assert int(got.sum()) > 0


@pytest.mark.parametrize("keys,window,want", [
    # the oracle pre-pads with -1 and says [1, 0, ...]; the Pallas kernel
    # says all 0
    ([-1, 3, 4, 5, 6, 8, 9, 10, 11], 8, [0] * 9),
    # the Pallas kernel pre-pads with -0x7FFFFFFE and says [0, 1, 0, ...];
    # the oracle says all 0
    ([7, -0x7FFFFFFE, 1, 2, 3, 4, 5, 6, 8], 8, [0] * 9),
    # shorter than window - 1: the oracle raises, the kernel says all 0
    ([1, 2, 3], 8, [0, 0, 0]),
    ([4, 4, 4], 8, [0, 1, 1]),
    ([], 8, []),
], ids=["leading_minus_one", "leading_kernel_sentinel", "short_stream",
        "short_repeats", "empty"])
def test_window_mask_stream_start_is_empty(keys, window, want):
    """The port's meaning at the stream start: a position before 0 holds
    nothing and never matches, whatever the key."""
    k = torch.as_tensor(np.array(keys, np.int32))
    got = coalesce_window_mask(k, window=window)
    assert got.dtype == torch.bool
    assert got.int().tolist() == want


SPAN = 512  # keys of a warp of the window kernel: 4 chunks x 32 lanes x 4


def _window_kernel_numpy(keys: np.ndarray, window: int,
                         offset: int) -> np.ndarray:
    """``csrc/coalesce_window.cu`` transliterated, lane by lane: the mask
    it writes for ``keys`` that start ``offset`` keys (4 bytes each) past a
    16-byte boundary.  The launcher's split (a scalar head until the keys
    align, whole spans of 512 keys a warp, a scalar tail), the dispatch
    (window 8 exact, halo capacity 16 or 31 otherwise), each lane's four
    keys in each of four chunks, its halo from the lanes before it
    (``__shfl_sync`` from lane ``(lane - dist) & 31``, which hands over its
    previous chunk's key where it is at the warp's end), the first chunk's
    low lanes reading global memory, the first span's check against
    positions before 0, and the scalar threads.  Every mask byte must be
    written exactly once."""
    m = keys.shape[0]
    out = np.zeros(m, np.uint8)
    writes = np.zeros(m, np.int64)
    if m == 0:  # the launcher returns before any launch
        return out
    halo = window - 1
    h, exact = (7, True) if window == 8 else \
        (16, False) if halo <= 16 else (31, False)
    head = min(m, (16 - 4 * offset) % 16 // 4)
    spans = (m - head) // SPAN
    n_scalar = m - spans * SPAN
    n_threads = -(-max(32 * spans, n_scalar) // 256) * 256  # whole blocks
    for w in range(spans):
        span = head + w * SPAN
        lane = np.arange(32)
        k = keys[span:span + SPAN].reshape(4, 32, 4)  # [chunk, lane, key]
        for q in range(4):
            base = span + 128 * q + 4 * lane
            a = np.zeros((32, h), np.int64)
            for j in range(h):
                back = h - j
                dist = (back + 3) // 4
                r = 4 * dist - back
                mine = np.where((q > 0) & (lane >= 32 - dist),
                                k[q - 1, :, r] if q > 0 else 0, k[q, :, r])
                a[:, j] = mine[(lane - dist) & 31]
                if q == 0:
                    low = lane < dist
                    pos = base - back
                    ok = low & (pos >= 0) & (exact or back <= halo)
                    a[ok, j] = keys[pos[ok]]
                    a[low & ~ok, j] = 0
            comb = np.concatenate([a, k[q]], axis=1)
            for p in range(4):
                hit = np.zeros(32, bool)
                for d in range(1, h + 1):
                    c = h + p - d
                    ok = comb[:, c] == k[q, :, p]
                    if not exact:
                        ok &= d <= halo
                    if span < h:
                        ok &= base + p - d >= 0
                    hit |= ok
                out[base + p] = hit
                writes[base + p] += 1
    for t in range(min(n_threads, n_scalar)):
        i = t if t < head else head + spans * SPAN + t - head
        reach = min(i, halo)
        out[i] = any(keys[i - d] == keys[i] for d in range(1, reach + 1))
        writes[i] += 1
    assert (writes == 1).all(), "a mask byte written other than once"
    return out


@pytest.mark.parametrize("window", range(2, 33))
def test_window_kernel_indexing_matches_plain(window):
    """The transliteration against the plain version at every length where
    the split changes (shorter than the halo, a head alone, a span less or
    more one key, several spans and a tail) and at every alignment of the
    first key, on streams that hold EMPTY_KEY and NO_CODE among a few
    keys, so that repeats fall at every distance."""
    rng = np.random.default_rng(window)
    lengths = (0, 1, window - 2, 15, 16, 17, 511, 512, 513, 514, 515,
               3 * 512 + 7)
    alphabet = np.array([-0x7FFFFFFF, -1] + list(range(window)), np.int32)
    hits = 0
    for m in lengths:
        for offset in range(4):
            keys = alphabet[rng.integers(0, alphabet.size, m)]
            got = _window_kernel_numpy(keys, window, offset)
            want = tdedup.windowed_coalesce_mask(torch.as_tensor(keys),
                                                 window)
            _eq(torch.as_tensor(got.astype(bool)), want,
                f"window {window} m={m} offset {offset}")
            hits += int(got.sum())
    assert hits > 0


@pytest.mark.parametrize("window", [1, 33])
def test_window_mask_rejects_unsupported_windows(window):
    with pytest.raises(ValueError, match="window"):
        coalesce_window_mask(torch.zeros(4, dtype=torch.int32),
                             window=window)


@pytest.mark.parametrize("s", ZIPF_S)
def test_zipf_sample_draws_match_jax(s):
    got = tskew.zipf_sample(1_000, 5_000, s, seed=7)
    want = jskew.zipf_sample(1_000, 5_000, s, seed=7)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(tskew.zipf_weights(50, s),
                                  jskew.zipf_weights(50, s))


@pytest.mark.parametrize("source", ["numpy", "tensor"])
@pytest.mark.parametrize("s", ZIPF_S)
def test_measure_skew_and_top_keys_match_jax(s, source):
    keys = jskew.zipf_sample(3_000, 20_000, s, seed=int(s * 4) + 1)
    arg = torch.as_tensor(keys) if source == "tensor" else keys
    got = tskew.measure_skew(arg)
    want = jskew.measure_skew(keys)
    assert [getattr(got, f) for f in ("n", "distinct", "dup_factor",
                                      "max_share", "top_share")] == \
        [getattr(want, f) for f in ("n", "distinct", "dup_factor",
                                    "max_share", "top_share")]
    for h in (0, 1, 64, 100, 1024, 4096, 40_000):
        assert got.coverage(h) == want.coverage(h)
    for h in (1, 64, 5_000):
        top = tskew.top_keys(arg, h)
        assert top.dtype == np.int32
        np.testing.assert_array_equal(top, jskew.top_keys(keys, h))
    assert tskew.skew_stats(arg) == jskew.skew_stats(keys)


def test_measure_skew_of_an_empty_stream_matches_jax():
    for arg in (np.zeros(0, np.int32), torch.zeros(0, dtype=torch.int32)):
        got = tskew.measure_skew(arg)
        want = jskew.measure_skew(np.zeros(0, np.int32))
        assert (got.n, got.distinct, got.dup_factor, got.max_share,
                got.top_share) == (want.n, want.distinct, want.dup_factor,
                                   want.max_share, want.top_share)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("spread, binned", [(1, True), (10_000, False)],
                         ids=["binned", "sorted"])
def test_tensor_counts_match_numpy_binned_or_sorted(dtype, spread, binned,
                                                    monkeypatch):
    """A tensor's values and counts equal ``np.unique``'s, whether its
    range is narrow enough to count in bins (a chunk of 7 keys at a time
    here, so that chunks split runs of one value) or is sorted."""
    monkeypatch.setattr(tskew, "BIN_CHUNK", 7)
    keys = (jskew.zipf_sample(300, 2_000, 1.0, seed=3).astype(np.int64)
            - 150) * spread
    t = torch.as_tensor(keys, dtype=dtype)
    assert (tskew._binned_counts(t) is not None) == binned
    vals, counts = tskew._unique_counts(t)
    want_vals, want_counts = np.unique(keys, return_counts=True)
    np.testing.assert_array_equal(vals, want_vals)
    np.testing.assert_array_equal(counts, want_counts)
    assert tskew.measure_skew(t) == tskew.measure_skew(keys)
    np.testing.assert_array_equal(tskew.top_keys(t, 50),
                                  tskew.top_keys(keys, 50))
