"""The port's kernels, through their plain versions, against the Pallas kernels.

On the CPU every ``repro_torch`` kernel wrapper takes its plain version, so
these tests hold the plain versions against the JAX package's Pallas
kernels run with ``interpret=True``, on the JAX registry's own cases
(drawn from the same numpy seeds) and on shape sweeps.  All arithmetic is
int32: equality is exact.  That the CUDA kernels equal these plain versions
is checked on the card by ``chip_smoke.py``.
"""
import itertools
from fractions import Fraction

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import delta as jdelta
from repro.core import hash_table as jht
from repro.kernels import bucket_probe as jbp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_query import fused_query as jfused_query
from repro_torch.core import delta as tdelta
from repro_torch.core import hash_table as tht
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bucket_probe import (bucket_probe_stream,
                                              pack_bits,
                                              probe_filter_rows,
                                              probe_filter_rows_delta,
                                              probe_rows)
from repro_torch.kernels.fused_query import (fingers, fused_query,
                                             fused_query_plain,
                                             pack_query_bits)

REGISTRY_CASES = [("probe_rows", 0), ("bucket_probe_stream", 0),
                  ("probe_filter_rows", 0)] + \
    [("probe_filter_rows_delta", i) for i in range(3)] + \
    [("fused_query", i) for i in range(4)] + [("coalesce_window_mask", 0)]


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int32))


def _eq(got, want, msg=""):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w, msg)
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


def test_registry_lists_the_on_path_kernels():
    assert sorted(tops.KERNEL_REGISTRY) == [
        "batched_tail", "bucket_probe_stream", "coalesce_window_mask",
        "fused_query", "probe_filter_rows", "probe_filter_rows_delta",
        "probe_rows"]
    assert all(len(tops.KERNEL_REGISTRY[n].make_cases("cpu")) > i
               for n, i in REGISTRY_CASES)
    for name, op in tops.KERNEL_REGISTRY.items():
        assert op.backends == ("cuda",)
        assert op.source.startswith("src/repro_torch/kernels/csrc/")
        # every kernel that replaces a Pallas kernel is the JAX registry's;
        # batched_tail replaces none (XLA fuses the reference's tail)
        assert (name in jops.KERNEL_REGISTRY) == (op.replaces is not None)
        assert op.replaces is None or op.replaces.startswith(
            "src/repro/kernels/")


@pytest.mark.parametrize("name,i", REGISTRY_CASES)
def test_registry_case_matches_pallas_interpret(name, i):
    pname, pargs, pkw = tops.KERNEL_REGISTRY[name].make_cases("cpu")[i]
    jname, jargs, jkw = jops.KERNEL_REGISTRY[name].make_cases()[i]
    assert pname == jname
    # the port's operands are the reference's: same planes once gathered
    # at the reference's bucket ids
    if name == "fused_query":
        gathered = tuple(_jax_gathered(ops) for ops in pargs[0])
        _eq(gathered, jargs[0], "dim operands")
        _eq(pargs[1], jargs[1], "fmeasure")
    elif name == "bucket_probe_stream":
        tk, tv, pk, mode = pargs
        _eq((tk, tv, pk), jargs[:3], "operands")
        _eq(_t(jht.hash_bucket(jnp.asarray(pk.numpy()), tk.shape[0], mode)),
            jargs[3], "bucket ids")
    elif name == "probe_rows":
        tk, tv, pk, mode = pargs
        b = _t(jht.hash_bucket(jnp.asarray(pk.numpy()), tk.shape[0],
                               mode)).long()
        _eq((pk, tk[b], tv[b]), jargs, "gathered rows")
    elif name == "coalesce_window_mask":
        _eq(pargs, jargs, "operands")  # the same operands in both
    elif name == "probe_filter_rows_delta":
        tk, tv, tp, pk, mode, dtk, dtw, raw, dmode = pargs
        b = tht.hash_bucket(pk, tk.shape[0], mode).long()
        db = tht.hash_bucket(raw, dtk.shape[0], dmode).long()
        _eq((pk, tk[b], tv[b], tp[b], raw, dtk[db], dtw[db]), jargs,
            "gathered rows")
    elif name == "probe_filter_rows":
        tk, tv, tp, pk, mode = pargs
        b = tht.hash_bucket(pk, tk.shape[0], mode).long()
        _eq((pk, tk[b], tv[b], tp[b]), jargs, "gathered rows")
    got = tops.KERNEL_REGISTRY[name].fn(*pargs, **pkw)
    want = jops.KERNEL_REGISTRY[name].fn(*jargs, **jkw, interpret=True)
    _eq(got, want)
    _eq(tops.KERNEL_REGISTRY[name].plain_fn(*pargs, **pkw), want)


def test_coalesce_window_zipf_case_matches_pallas_interpret():
    """The port's second case (a Zipf stream over several 256-key blocks),
    which the reference registry lacks, against the Pallas kernel."""
    from repro.kernels.coalesce_window import coalesce_window_mask as jcwm
    op = tops.KERNEL_REGISTRY["coalesce_window_mask"]
    name, (keys,), kw = op.make_cases("cpu")[1]
    assert name == "zipf_stream" and keys.shape == (1000,)
    want = jcwm(jnp.asarray(keys.numpy()), window=8, block=256,
                interpret=True)
    _eq(op.fn(keys, **kw), want)
    _eq(op.plain_fn(keys, **kw), want)
    assert int(op.fn(keys, **kw).sum()) > 0


def _sweep_table(width, n_keys=200, seed=0, hash_mode=tht.HASH_IDENTITY):
    rng = np.random.default_rng(seed)
    keys = rng.choice(n_keys * 4, n_keys, replace=False).astype(np.int32)
    vals = rng.integers(0, 1 << 20, n_keys).astype(np.int32)
    nb = tht.suggest_num_buckets(n_keys, width)
    return (tht.build_table(_t(keys), _t(vals), num_buckets=nb,
                            bucket_width=width, hash_mode=hash_mode),
            jht.build_table(jnp.asarray(keys), jnp.asarray(vals),
                            num_buckets=nb, bucket_width=width,
                            hash_mode=hash_mode))


def _sweep_probes(m, seed):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 900, m).astype(np.int32)
    pk[::11] = tht.EMPTY_KEY
    return pk


HASH_MODES = [tht.HASH_IDENTITY, tht.HASH_FIBONACCI]


def _sweep_cases(shapes, modes):
    """pytest params over shapes x hash modes; the first mode's cases keep
    the ids the shapes alone had (``m-width...``), the others add the
    mode's name."""
    return [pytest.param(*shape, *mode, id="-".join(
        [str(shape[-1]), *map(str, shape[:-1])] + ([name] if name else [])))
            for name, mode in modes for shape in shapes]


@pytest.mark.parametrize("width,m,hash_mode", _sweep_cases(
    [(w, m) for w in (8, 16) for m in (1, 7, 300)],
    [("", (tht.HASH_IDENTITY,)), ("fibonacci", (tht.HASH_FIBONACCI,))]))
def test_probe_kernels_shape_sweep(width, m, hash_mode):
    """m not a multiple of the Pallas block (64 here); negative probe keys
    and EMPTY_KEY among them.  ``probe_rows`` and ``probe_filter_rows``
    hash the keys themselves; the Pallas kernels get rows gathered by the
    reference's hash."""
    tt, jt = _sweep_table(width, hash_mode=hash_mode)
    pk = _sweep_probes(m, m)
    pk[3::13] = -pk[3::13] - 1
    jb = jht.hash_bucket(jnp.asarray(pk), jt.num_buckets, jt.hash_mode)
    got = probe_rows(tt.keys, tt.values, _t(pk), hash_mode)
    want = jbp.probe_rows(jnp.asarray(pk), jt.keys[jb], jt.values[jb],
                          block_pb=64, interpret=True)
    _eq(got, want)
    mask = torch.as_tensor(np.arange(200) % 4 != 1)
    pred = tops.slot_predicate(tt, mask)
    _eq(pred, jops.slot_predicate(jt, jnp.asarray(mask.numpy())))
    got = probe_filter_rows(tt.keys, tt.values, pred, _t(pk), hash_mode)
    want = jbp.probe_filter_rows(jnp.asarray(pk), jt.keys[jb], jt.values[jb],
                                 jnp.asarray(pred.numpy())[jb], block_pb=64,
                                 interpret=True)
    _eq(got, want)


def _dup_table(width, hash_mode, seed):
    """A sweep table's planes (numpy) where a third of the lanes after the
    first repeat their bucket's first key: a probe sums every lane that
    holds its key."""
    tt, _ = _sweep_table(width, hash_mode=hash_mode, seed=seed)
    tk = tt.keys.numpy()
    rng = np.random.default_rng(seed)
    dup = (rng.random(tk.shape) < 1 / 3) & (tk[:, :1] != tht.EMPTY_KEY)
    dup[:, 0] = False
    return np.where(dup, tk[:, :1], tk).astype(np.int32), tt.values.numpy()


@pytest.mark.parametrize("width,hash_mode", [
    (4, tht.HASH_FIBONACCI), (8, tht.HASH_IDENTITY), (16, tht.HASH_FIBONACCI),
    (32, tht.HASH_IDENTITY), (128, tht.HASH_FIBONACCI)])
@pytest.mark.parametrize("case", ["empty_key_probes", "duplicate_keys",
                                  "m0", "m_not_block_multiple"])
def test_probe_rows_edge_cases(case, width, hash_mode):
    """``probe_rows(keys, vals, probe_keys, hash_mode)`` against the Pallas
    kernel fed rows gathered at the reference's ``hash_bucket`` ids: half
    the probes EMPTY_KEY (which the table's empty slots hold: still a
    miss), duplicate keys in a bucket (their values summed), no probes,
    and 1,283 probes (not a multiple of the rows kernel's 256-probe
    blocks or of the table kernel's 4,096 probes a step).  The bucket
    planes hold keys 0..799; a fifth of the probes are drawn from
    -900..899."""
    seed = width + len(case)
    if case == "duplicate_keys":
        tk, tv = _dup_table(width, hash_mode, seed)
    else:
        tt, _ = _sweep_table(width, hash_mode=hash_mode, seed=seed)
        tk, tv = tt.keys.numpy(), tt.values.numpy()
    rng = np.random.default_rng(seed)
    m = {"m0": 0, "m_not_block_multiple": 1283}.get(case, 300)
    live = tk[tk != tht.EMPTY_KEY]
    pk = rng.choice(live, m).astype(np.int32)
    pk[::5] = rng.integers(-900, 900, len(pk[::5]))
    if case == "empty_key_probes":
        pk[::2] = tht.EMPTY_KEY
    got = probe_rows(_t(tk), _t(tv), _t(pk), hash_mode)
    jb = np.asarray(jht.hash_bucket(jnp.asarray(pk), tk.shape[0], hash_mode))
    jops_ = (jnp.asarray(pk), jnp.asarray(tk[jb]), jnp.asarray(tv[jb]))
    # the Pallas kernel's interpret mode refuses m = 0 (a block of 8 rows
    # sliced out of 0): there its oracle
    want = jref.probe_rows_ref(*jops_) if m == 0 else \
        jbp.probe_rows(*jops_, block_pb=64, interpret=True)
    assert got.shape == (m,) and got.dtype == torch.int32
    _eq(got, want)
    if case == "empty_key_probes":
        assert (got.numpy()[::2] == jref.NULL_WORD).all()
    elif case == "duplicate_keys":
        rows = tk[jb] == pk[:, None]
        assert (rows.sum(axis=1) > 1).any()  # some probe sums two lanes
    if m:
        assert (got.numpy() != jref.NULL_WORD).any()


@pytest.mark.parametrize("m,width,hash_mode", [
    pytest.param(m, w, tht.HASH_IDENTITY, id=f"{m}-{w}")
    for m in (1, 7, 300) for w in (8, 16)] + [
    pytest.param(m, w, mode, id=f"{m}-{w}-{mode}")
    for m, w, mode in ((300, 4, tht.HASH_FIBONACCI),
                       (300, 8, tht.HASH_FIBONACCI),
                       (83, 32, tht.HASH_IDENTITY),
                       (300, 64, tht.HASH_FIBONACCI),
                       (83, 128, tht.HASH_IDENTITY))])
def test_bucket_probe_stream_shape_sweep(m, width, hash_mode):
    """The stream kernel hashes the keys itself; the Pallas kernel (one
    grid step per probe in interpret mode) gets the reference's bucket ids.
    Negative probe keys and EMPTY_KEY among the probes."""
    tt, jt = _sweep_table(width, hash_mode=hash_mode)
    pk = _sweep_probes(m, m)
    pk[3::13] = -pk[3::13] - 1
    jb = jht.hash_bucket(jnp.asarray(pk), jt.num_buckets, jt.hash_mode)
    got = bucket_probe_stream(tt.keys, tt.values, _t(pk), hash_mode)
    want = jbp.bucket_probe_stream(jt.keys, jt.values, jnp.asarray(pk), jb,
                                   block_pb=64, interpret=True)
    _eq(got, want)
    _eq(got, probe_rows(tt.keys, tt.values, _t(pk), hash_mode))


@pytest.mark.parametrize("width,dwidth,m,hash_mode,delta_hash_mode",
                         _sweep_cases(
    [(w, dw, m) for w, dw in ((8, 8), (16, 4)) for m in (1, 7, 300)],
    [("", (tht.HASH_IDENTITY, tht.HASH_FIBONACCI)),
     ("swapped", (tht.HASH_FIBONACCI, tht.HASH_IDENTITY))]))
def test_probe_filter_rows_delta_shape_sweep(width, dwidth, m, hash_mode,
                                             delta_hash_mode):
    """A live delta with upserts (some past the dimension), tombstones and
    new keys, built by each package's own delta ops.  The engine's pairing
    (dictionary codes by identity, raw keys by Fibonacci) and the other
    way round; negative probe keys and EMPTY_KEY among the probes."""
    tt, jt = _sweep_table(width, hash_mode=hash_mode)
    rng = np.random.default_rng(m + width)
    td = tdelta.empty_delta(8, dwidth, hash_mode=delta_hash_mode)
    jd = jdelta.empty_delta(8, dwidth, hash_mode=delta_hash_mode)
    ups = rng.integers(0, 900, 12).astype(np.int32)
    pays = rng.integers(0, 230, 12).astype(np.int32)
    dels = rng.integers(0, 900, 5).astype(np.int32)
    td = tdelta.delete_batch(tdelta.upsert_batch(td, _t(ups), _t(pays)),
                             _t(dels))
    jd = jdelta.delete_batch(jdelta.upsert_batch(jd, jnp.asarray(ups),
                                                 jnp.asarray(pays)),
                             jnp.asarray(dels))
    pk = _sweep_probes(m, m)
    pk[3::13] = -pk[3::13] - 1
    pk[: min(m, 12)] = ups[: min(m, 12)]
    mask = np.arange(200) % 4 != 1
    pred = tops.slot_predicate(tt, torch.as_tensor(mask))
    dwords = tops.delta_slot_words(td, torch.as_tensor(mask))
    _eq(dwords, jops.delta_slot_words(jd, jnp.asarray(mask)))
    got = probe_filter_rows_delta(tt.keys, tt.values, pred, _t(pk),
                                  hash_mode, td.keys, dwords, _t(pk),
                                  delta_hash_mode)
    jb = np.asarray(jht.hash_bucket(jnp.asarray(pk), jt.num_buckets,
                                    jt.hash_mode))
    jdb = np.asarray(jht.hash_bucket(jnp.asarray(pk), jd.num_buckets,
                                     jd.hash_mode))
    want = jbp.probe_filter_rows_delta(
        jnp.asarray(pk), jt.keys[jb], jt.values[jb],
        jnp.asarray(pred.numpy())[jb], jnp.asarray(pk), jd.keys[jdb],
        jnp.asarray(dwords.numpy())[jdb], block_pb=64, interpret=True)
    _eq(got, want)


def _bits(words, n):
    """The first ``n`` bits of int32 words, as a flat 0/1 array, and the
    rest (which must be 0)."""
    bits = ((words.long()[:, None] >> torch.arange(32)) & 1).reshape(-1)
    return bits[:n].numpy(), bits[n:].numpy()


@pytest.mark.parametrize("width", [4, 8, 16, 32, 64, 128])
def test_pack_bits_equal_the_slot_plane(width):
    """Bit ``b W + j`` of the packed slot words is slot ``(b, j)`` of
    ``slot_predicate``'s plane, duplication-group slots (which keep 1)
    included, and bucket bit ``b`` is "some slot of bucket ``b`` passes";
    the same for the key plane's occupied slots.  A table of fewer than 32
    slots packs into one word."""
    rng = np.random.default_rng(width)
    keys = rng.integers(0, 300, 400).astype(np.int32)  # duplicates: groups
    table = tht.build_table(_t(keys), _t(np.arange(400)),
                            num_buckets=tht.suggest_num_buckets(300, width),
                            bucket_width=width)
    assert int(table.group_count.gt(1).sum()) > 0
    pred = tops.slot_predicate(table, torch.as_tensor(rng.random(400) < 0.3))
    is_dup = (table.values & 1).bool() & (table.keys != tht.EMPTY_KEY)
    assert bool(pred[is_dup].eq(1).all()) and int(is_dup.sum()) > 0
    cases = [(pred, "positive", pred.bool()),
             (table.keys, "occupied", table.keys != tht.EMPTY_KEY)]
    cases += [(p[:1, :4].contiguous(), t, f[:1, :4]) for p, t, f in cases]
    for plane, test, flags in cases:
        slots, buckets = pack_bits(plane, test)
        nb, n = plane.shape[0], plane.numel()
        assert slots.dtype == buckets.dtype == torch.int32
        assert slots.shape == (max(1, n // 32),)
        assert buckets.shape == ((nb + 31) // 32,)
        head, tail = _bits(slots, n)
        _eq(_t(head), flags.reshape(-1).int().numpy(), test)
        assert not tail.any()
        head, tail = _bits(buckets, nb)
        _eq(_t(head), flags.any(dim=1).int().numpy(), test)
        assert not tail.any()
        assert head.sum() > 0 or nb == 1


def _kernel_hash(keys, num_buckets, mode):
    """``bucket_of`` in ``csrc/bucket_probe.cu``, line for line: the key's
    int32 bits times 2654435769 mod 2^32 (a wrapping int32 product has the
    uint32 product's bits), shifted down to the top ``max(1, bit_length(
    num_buckets - 1))`` bits, masked; or the key masked.  The mask also
    drops the sign bits an arithmetic shift brings in."""
    k = keys.to(torch.int32)
    if mode == tht.HASH_FIBONACCI:
        bits = 1
        while (1 << bits) < num_buckets:  # make_hash
            bits += 1
        k = (k * (2654435769 - (1 << 32))) >> (32 - bits)
    return k & (num_buckets - 1)


@pytest.mark.parametrize("num_buckets", [1, 2, 8, 1 << 19, 1 << 30])
def test_kernel_hash_equals_hash_bucket(num_buckets):
    """The filter kernels' in-kernel hash, written in PyTorch, equals both
    packages' ``hash_bucket`` (what the plain versions use): one bucket,
    negative keys (their int32 bits taken as uint32), EMPTY_KEY and the
    int32 ends."""
    rng = np.random.default_rng(num_buckets)
    keys = np.concatenate([
        [0, 1, -1, -2, tht.EMPTY_KEY, -2**31, 2**31 - 1, 2**30],
        rng.integers(-2**31, 2**31, 500)]).astype(np.int32)
    for mode in HASH_MODES:
        got = _kernel_hash(_t(keys), num_buckets, mode)
        want = tht.hash_bucket(_t(keys), num_buckets, mode)
        assert got.dtype == torch.int32
        _eq(got, want.numpy(), mode)
        _eq(got, jht.hash_bucket(jnp.asarray(keys), num_buckets, mode), mode)
        assert int(got.min()) >= 0 and int(got.max()) < num_buckets


def _jax_gathered(ops):
    """A port dimension's fused operands as the Pallas kernel takes them:
    its planes gathered at the reference's ``hash_bucket`` ids."""
    def gather(keys, tk, ta, mode):
        k = keys.numpy()
        b = np.asarray(jht.hash_bucket(jnp.asarray(k), tk.shape[0], mode))
        return (_t(k), _t(tk.numpy()[b]), _t(ta.numpy()[b]))
    out = gather(*ops[:4])
    return out + gather(*ops[4:]) if len(ops) == 8 else out


def _fused_operands(n_dims, width, m, num_segments, seed,
                    hash_mode=tht.HASH_IDENTITY, delta=False, wide=False):
    """Random attribute planes over real tables: (port ops, jax ops, fm).

    ``delta``: each dimension also gets a live delta (the other hash mode)
    built by each package's own delta ops: upserts of probed keys with
    random attributes (some make a row pass that the main table rejects),
    deletes whose tombstones carry -1, and new keys.  ``wide``: group parts
    up to ``num_segments`` per dimension, so that some composite keys fall
    outside ``[0, num_segments)``.  About 70% of the probe keys are in the
    table."""
    rng = np.random.default_rng(seed)
    dmode = (tht.HASH_FIBONACCI if hash_mode == tht.HASH_IDENTITY
             else tht.HASH_IDENTITY)
    port, jax_ops = [], []

    def attr_plane(shape):
        hi = max(1, num_segments // n_dims + (num_segments // 3 if wide
                                              else 0))
        attr = ((rng.integers(0, hi, shape) << 1)
                | rng.integers(0, 2, shape)).astype(np.int32)
        attr[rng.random(shape) < 0.1] = -1
        return attr

    for d in range(n_dims):
        tt, _ = _sweep_table(width, seed=seed + d, hash_mode=hash_mode)
        pk = _sweep_probes(m, seed + 10 * d)
        live = tt.keys[tt.keys != tht.EMPTY_KEY].numpy()
        hits = rng.random(m) < 0.7
        pk[hits] = rng.choice(live, int(hits.sum()))
        pk[3::13] = -pk[3::13] - 1
        ops = (_t(pk), tt.keys, _t(attr_plane(tt.keys.shape)), hash_mode)
        if delta:
            ups = rng.choice(pk, 12).astype(np.int32)
            dels = rng.choice(pk, 5).astype(np.int32)
            news = rng.integers(900, 1000, 4).astype(np.int32)
            td = tdelta.empty_delta(8, 8, hash_mode=dmode)
            jd = jdelta.empty_delta(8, 8, hash_mode=dmode)
            for mod, dl in ((tdelta, td), (jdelta, jd)):
                arr = _t if mod is tdelta else jnp.asarray
                dl = mod.upsert_batch(dl, arr(np.concatenate([ups, news])),
                                      arr(np.arange(16, dtype=np.int32)))
                dl = mod.delete_batch(dl, arr(dels))
                if mod is tdelta:
                    td = dl
                else:
                    jd = dl
            _eq(td.keys, jd.keys, "delta keys")
            dattr = attr_plane(td.keys.shape)
            dattr[(td.words == tdelta.TOMBSTONE).numpy()] = -1
            ops += (_t(pk), td.keys, _t(dattr), dmode)
        port.append(ops)
        jax_ops.append(tuple(jnp.asarray(t.numpy())
                             for t in _jax_gathered(ops)))
    fm = rng.integers(-1000, 100_000, m).astype(np.int32)
    fm[rng.random(m) < 0.2] = 0
    return tuple(port), tuple(jax_ops), fm


@pytest.mark.parametrize("n_dims,width", [(1, 8), (3, 16), (4, 8)])
@pytest.mark.parametrize("m,num_segments", [(7, 1), (300, 37), (257, 4000)])
def test_fused_query_shape_sweep(n_dims, width, m, num_segments):
    port, jax_ops, fm = _fused_operands(n_dims, width, m, num_segments,
                                        seed=n_dims * 100 + m)
    got = fused_query(port, _t(fm), num_segments=num_segments)
    want = jfused_query(jax_ops, jnp.asarray(fm), num_segments=num_segments,
                        block_pb=64, interpret=True)
    _eq(got, want)


@pytest.mark.parametrize("n_dims,width,hash_mode,delta", [
    (1, 4, tht.HASH_FIBONACCI, True), (2, 8, tht.HASH_FIBONACCI, True),
    (3, 16, tht.HASH_IDENTITY, True), (4, 8, tht.HASH_FIBONACCI, False),
    (2, 32, tht.HASH_IDENTITY, True), (2, 64, tht.HASH_FIBONACCI, True),
    (1, 128, tht.HASH_IDENTITY, True)])
def test_fused_query_hash_modes_widths_deltas(n_dims, width, hash_mode,
                                              delta):
    """Both hash modes, W from 4 to 128, live deltas with upserts and
    tombstones, composite keys out of range: the plain version (which
    hashes with ``hash_bucket``) against the Pallas kernel fed the
    reference's bucket ids and gathered rows."""
    port, jax_ops, fm = _fused_operands(n_dims, width, 1000, 37,
                                        seed=7 * width + n_dims,
                                        hash_mode=hash_mode, delta=delta,
                                        wide=True)
    got = fused_query(port, _t(fm), num_segments=37)
    want = jfused_query(jax_ops, jnp.asarray(fm), num_segments=37,
                        block_pb=64, interpret=True)
    _eq(got, want)
    assert int(got[1].ne(0).sum()) > 0


@pytest.mark.parametrize("delta", [False, True])
def test_fused_query_plain_is_order_free(delta):
    """The kernel probes the most selective dimension first: the answer
    must not depend on the order of the dimensions."""
    port, _, fm = _fused_operands(4, 8, 300, 4000, seed=5, delta=delta)
    want = fused_query_plain(port, _t(fm), num_segments=4000)
    assert int(want[1].ne(0).sum()) > 0
    for perm in itertools.permutations(range(4)):
        _eq(fused_query_plain(tuple(port[i] for i in perm), _t(fm),
                              num_segments=4000), want, str(perm))


def _bit(words, i) -> bool:
    return bool((int(words[i >> 5]) >> (i & 31)) & 1)


def _screened_query(dim_operands, fm, num_segments):
    """``query_kernel`` of ``csrc/fused_query.cu`` in Python, on
    ``pack_query_bits``' output: the dimensions sorted by passing /
    occupied slots; per row and dimension the main bucket and fingerprint
    bits, then the delta (its key row only where its bucket's occupancy
    bit is set, or its pass bit where the main bits are not), then the
    bucket's passing row.  Returns the groups and the number of passing
    rows read."""
    bits, stats = pack_query_bits(dim_operands)
    stats = stats.tolist()
    # a stable sort on passing / occupied, as the kernel's insertion sort
    order = sorted(range(len(dim_operands)),
                   key=lambda d: Fraction(stats[d][0], max(1, stats[d][1])))
    groups = np.zeros(num_segments, np.int64)
    rows_read = 0

    def lanes(tk, b, k):
        return [j for j in range(tk.shape[1]) if int(tk[b, j]) == k]

    def wrap(x):
        return (x + 2**31) % 2**32 - 2**31

    for i in range(fm.shape[0]):
        gk, keep = 0, True
        for d in order:
            ops = dim_operands[d]
            bucket_bits, finger, passing, dpass, docc = bits[d]
            pk, tk, ta, mode = ops[:4]
            k = int(pk[i])
            b = int(tht.hash_bucket(pk[i:i + 1], tk.shape[0], mode))
            f = int(fingers(pk[i:i + 1], tk.shape[0], mode))
            main = k != tht.EMPTY_KEY and _bit(bucket_bits, b) and \
                (int(finger[b]) >> f) & 1
            if len(ops) == 8:
                dpk, dtk, dta, dmode = ops[4:]
                dk = int(dpk[i])
                db = int(tht.hash_bucket(dpk[i:i + 1], dtk.shape[0], dmode))
                hit = lanes(dtk, db, dk) if dk != tht.EMPTY_KEY and \
                    _bit(docc if main else dpass, db) else []
                if hit:
                    attr = wrap(sum(int(dta[db, j]) for j in hit))
                    if attr < 0 or attr % 2 == 0:
                        keep = False
                        break
                    gk += attr >> 1
                    continue
            if not main:
                keep = False
                break
            rows_read += 1
            group = None
            for key, part in passing[b].tolist():
                if key in (k, tht.EMPTY_KEY):
                    group = part if key == k else None
                    break
            if group is None:
                keep = False
                break
            gk += group
        gk = wrap(gk)
        if keep and 0 <= gk < num_segments:
            groups[gk] += int(fm[i])
    return _t(wrap(groups)), rows_read


@pytest.mark.parametrize("case", ["sweep", "sweep_delta", "upsert_tomb"])
def test_fused_query_screen_rule_matches_plain(case):
    """The kernel's screen, transliterated, gives the plain answer: on
    seeded sweeps, and on a case built so that a delta upsert makes a row
    pass that the main table rejects, and a tombstone rejects a row that
    the main table passes.  The screen must also skip key rows."""
    if case != "upsert_tomb":
        port, _, fm = _fused_operands(3, 8, 300, 4000, seed=11,
                                      delta=case == "sweep_delta")
        fm = _t(fm)
    else:
        n = 64
        keys = _t(np.arange(n))
        tt = tht.build_table(keys, _t(np.arange(n) * 2), num_buckets=16,
                             bucket_width=8)
        # attribute: group part = key, predicate bit = key is odd
        attr = torch.where(tt.keys == tht.EMPTY_KEY, -1,
                           (tt.keys << 1) | (tt.keys & 1)).to(torch.int32)
        td = tdelta.empty_delta(8, 8, hash_mode=tht.HASH_FIBONACCI)
        td = tdelta.upsert_batch(td, _t([10, 12]), _t([0, 0]))
        td = tdelta.delete_batch(td, _t([11]))
        # delta attribute: the upserts pass (10 -> group 5, 12 -> 6)
        dattr = torch.full(td.keys.shape, -1, dtype=torch.int32)
        dattr[td.keys == 10] = (5 << 1) | 1
        dattr[td.keys == 12] = (6 << 1) | 1
        pk = _t([10, 11, 12, 13, 15, 20, tht.EMPTY_KEY, 33])
        port = ((pk, tt.keys, attr, tht.HASH_IDENTITY, pk, td.keys, dattr,
                 tht.HASH_FIBONACCI),)
        fm = _t([1, 10, 100, 1000, 10_000, 7, 9, 100_000])
    want = fused_query_plain(port, fm, num_segments=4000)
    got, rows_read = _screened_query(port, fm, 4000)
    _eq(got, want[1].numpy())
    if case == "upsert_tomb":
        # 10 and 12 pass through the delta (the main table rejects even
        # keys), 11 is a tombstone, 13, 15 and 33 pass, 20 and EMPTY_KEY not
        expect = np.zeros(4000, np.int64)
        for g, v in ((5, 1), (6, 100), (13, 1000), (15, 10_000),
                     (33, 100_000)):
            expect[g] += v
        _eq(want[1], expect)
    else:
        assert int(want[1].ne(0).sum()) > 0
    assert rows_read < sum(fm.shape[0] for _ in port)


def test_fused_query_q43_segment_space_matches_reference():
    """Q4.3's 1,750,000 segments: against the JAX reference oracle (a
    Pallas interpret run would hold the whole histogram per grid step)."""
    size = 1_750_000
    port, jax_ops, fm = _fused_operands(4, 8, 500, size, seed=43)
    got = fused_query(port, _t(fm), num_segments=size)
    want = jref.fused_query_ref(jax_ops, jnp.asarray(fm), num_segments=size)
    _eq(got, want)
    assert int(got[1].ne(0).sum()) > 0


def test_segment_sum_drops_out_of_range_ids():
    data = _t([5, 7, 11, 13])
    seg = _t([0, -1, 3, 1])
    _eq(tref.segment_sum(data, seg, 3), [5, 13, 0])


def test_plain_sums_wrap_like_int32():
    """Totals wrap mod 2^32 exactly as jnp.sum does."""
    m = 64
    pk = np.zeros(m, np.int32)
    keys = _t(np.zeros((1, 8), np.int32))
    attr = _t(np.full((1, 8), 1, np.int32))  # group 0, predicate 1
    fm = np.full(m, 2**30, np.int32)
    ops = ((_t(pk), keys, attr, tht.HASH_IDENTITY),)
    total, groups = fused_query(ops, _t(fm), num_segments=1)
    want = jref.fused_query_ref(((jnp.asarray(pk), jnp.zeros((m, 8),
                                                             jnp.int32),
                                  jnp.ones((m, 8), jnp.int32)),),
                                jnp.asarray(fm), num_segments=1)
    _eq(total, want[0])
    _eq(groups, want[1])


@pytest.mark.parametrize("bad", ["dtype", "shape", "ndims", "meta_device"])
def test_wrappers_reject_bad_operands(bad):
    table, pk = tops._probe_cases("cpu")
    keys, vals, mode = table.keys, table.values, table.hash_mode
    if bad == "dtype":
        pk = pk.long()
    elif bad == "shape":
        vals = vals[:-1]
    elif bad == "meta_device":
        keys, vals, pk = (t.to("meta") for t in (keys, vals, pk))
    if bad == "ndims":
        with pytest.raises(ValueError):
            fused_query((), pk, num_segments=1)
        return
    with pytest.raises(ValueError):
        probe_rows(keys, vals, pk, mode)


_C_TYPES = {"const void*": _build._P, "void*": _build._P,
            "int64_t": _build._I64, "int32_t": _build._I32}


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_the_sources(lib):
    """Every ``extern "C"`` launcher of ``csrc/<lib>.cu`` is declared in
    ``_build.SIGNATURES`` with its parameters' ctypes, in order: a pointer
    passed without its argtype would be cut to 32 bits."""
    import re
    src = (_build.CSRC / f"{lib}.cu").read_text()
    found = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        types = [re.sub(r"\s+\w+$", "", p.strip())
                 for p in params.split(",")]
        found[name] = tuple(_C_TYPES[t] for t in types)
    assert found == _build.SIGNATURES[lib]


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_cpu_tensors_never_load_the_cuda_library():
    before = {n: op.fn.launches for n, op in tops.KERNEL_REGISTRY.items()}
    for op in tops.KERNEL_REGISTRY.values():
        for _, args, kw in op.make_cases("cpu"):
            op.fn(*args, **kw)
    assert _build.loaded() == ()
    assert {n: op.fn.launches for n, op in tops.KERNEL_REGISTRY.items()} \
        == before == {n: 0 for n in tops.KERNEL_REGISTRY}
