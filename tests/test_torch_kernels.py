"""The port's kernels, through their plain versions, against the Pallas kernels.

On the CPU every ``repro_torch`` kernel wrapper takes its plain version, so
these tests hold the plain versions against the JAX package's Pallas
kernels run with ``interpret=True``, on the JAX registry's own cases
(drawn from the same numpy seeds) and on shape sweeps.  All arithmetic is
int32: equality is exact.  That the CUDA kernels equal these plain versions
is checked on the card by ``chip_smoke.py``.
"""
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
from repro_torch.kernels.fused_query import _gather, fused_query

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
        "bucket_probe_stream", "coalesce_window_mask", "fused_query",
        "probe_filter_rows", "probe_filter_rows_delta", "probe_rows"]
    assert all(len(tops.KERNEL_REGISTRY[n].make_cases("cpu")) > i
               for n, i in REGISTRY_CASES)
    for name, op in tops.KERNEL_REGISTRY.items():
        assert op.backends == ("cuda",)
        assert op.source.startswith("src/repro_torch/kernels/csrc/")
        assert name in jops.KERNEL_REGISTRY


@pytest.mark.parametrize("name,i", REGISTRY_CASES)
def test_registry_case_matches_pallas_interpret(name, i):
    pname, pargs, pkw = tops.KERNEL_REGISTRY[name].make_cases("cpu")[i]
    jname, jargs, jkw = jops.KERNEL_REGISTRY[name].make_cases()[i]
    assert pname == jname
    # the port's operands are the reference's: same planes once gathered
    if name == "fused_query":
        gathered = tuple(_gather(ops) for ops in pargs[0])
        _eq(gathered, jargs[0], "dim operands")
        _eq(pargs[1], jargs[1], "fmeasure")
    elif name in ("bucket_probe_stream", "coalesce_window_mask"):
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
    else:
        b = pargs[-1].long()
        _eq(pargs[-2], jargs[0], "probe keys")
        for plane, rows in zip(pargs[:-2], jargs[1:]):
            _eq(plane[b], rows, "gathered rows")
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
    and EMPTY_KEY among them.  ``probe_filter_rows`` hashes the keys
    itself; the Pallas kernel gets rows gathered by the reference's hash."""
    tt, jt = _sweep_table(width, hash_mode=hash_mode)
    pk = _sweep_probes(m, m)
    pk[3::13] = -pk[3::13] - 1
    bids = tht.hash_bucket(_t(pk), tt.num_buckets, tt.hash_mode)
    jb = jht.hash_bucket(jnp.asarray(pk), jt.num_buckets, jt.hash_mode)
    got = probe_rows(tt.keys, tt.values, _t(pk), bids)
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


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("m", [1, 7, 300])
def test_bucket_probe_stream_shape_sweep(width, m):
    """The stream kernel's grid runs one step per probe in interpret mode."""
    tt, jt = _sweep_table(width)
    pk = _sweep_probes(m, m)
    bids = tht.hash_bucket(_t(pk), tt.num_buckets, tt.hash_mode)
    jb = jht.hash_bucket(jnp.asarray(pk), jt.num_buckets, jt.hash_mode)
    got = bucket_probe_stream(tt.keys, tt.values, _t(pk), bids)
    want = jbp.bucket_probe_stream(jt.keys, jt.values, jnp.asarray(pk), jb,
                                   block_pb=64, interpret=True)
    _eq(got, want)
    _eq(got, probe_rows(tt.keys, tt.values, _t(pk), bids))


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


def _fused_operands(n_dims, width, m, num_segments, seed):
    """Random attribute planes over real tables: (port ops, jax ops, fm)."""
    rng = np.random.default_rng(seed)
    port, jax_ops = [], []
    for d in range(n_dims):
        tt, jt = _sweep_table(width, seed=seed + d)
        hi = max(1, num_segments // n_dims)
        attr = ((rng.integers(0, hi, tt.keys.shape) << 1)
                | rng.integers(0, 2, tt.keys.shape)).astype(np.int32)
        attr[rng.random(tt.keys.shape) < 0.1] = -1
        pk = _sweep_probes(m, seed + 10 * d)
        bids = tht.hash_bucket(_t(pk), tt.num_buckets, tt.hash_mode)
        jb = np.asarray(jht.hash_bucket(jnp.asarray(pk), jt.num_buckets,
                                        jt.hash_mode))
        port.append((_t(pk), bids, tt.keys, _t(attr)))
        jax_ops.append((jnp.asarray(pk), jt.keys[jb], jnp.asarray(attr[jb])))
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
    ops = ((_t(pk), _t(np.zeros(m, np.int32)), keys, attr),)
    total, groups = fused_query(ops, _t(fm), num_segments=1)
    want = jref.fused_query_ref(((jnp.asarray(pk), jnp.zeros((m, 8),
                                                             jnp.int32),
                                  jnp.ones((m, 8), jnp.int32)),),
                                jnp.asarray(fm), num_segments=1)
    _eq(total, want[0])
    _eq(groups, want[1])


@pytest.mark.parametrize("bad", ["dtype", "shape", "ndims", "meta_device"])
def test_wrappers_reject_bad_operands(bad):
    table, pk, bids = tops._probe_cases("cpu")
    keys, vals = table.keys, table.values
    if bad == "dtype":
        pk = pk.long()
    elif bad == "shape":
        bids = bids[:-1]
    elif bad == "meta_device":
        keys, vals, pk, bids = (t.to("meta") for t in (keys, vals, pk, bids))
    if bad == "ndims":
        with pytest.raises(ValueError):
            fused_query((), pk, num_segments=1)
        return
    with pytest.raises(ValueError):
        probe_rows(keys, vals, pk, bids)


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
