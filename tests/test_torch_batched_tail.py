"""The batched query-tail kernel's plain version and its operands.

``kernels/batched_tail.py`` answers every request of a dispatch from
operands built once per dispatch (request bits per dimension row, group
parts, the fact filter's word per fact row, the measure's columns).  On the
CPU its wrapper takes the plain version, which takes the same operands as
the kernel; here it is held against ``_filter_aggregate`` of each bound
request, bit for bit, on all 13 queries at widths 1, 3 and 33 (past one
32-request pass), over a fact table with capacity-padding rows and probe
misses, and with measures that overflow int32.  The card test holds the
kernel against the plain version (``python -m pytest -m card
tests/test_torch_batched_tail.py -s`` on the card).
"""
import importlib
import os

import numpy as np
import pytest
import torch

from repro_torch.engine import (SSB_QUERIES, SSBEngine, generate_fact_batch,
                                generate_ssb)
from repro_torch.engine.queries import _filter_aggregate
from repro_torch.kernels import _build
from repro_torch.serving import PARAM_QUERIES, BatchRunner
from repro_torch.serving import batch as pbatch

# the package exports the function ``batched_tail`` under the module's name
bt = importlib.import_module("repro_torch.kernels.batched_tail")
NAMES = sorted(SSB_QUERIES)
WIDTHS = (1, 3, 33)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_when_parallel():
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    """The CUDA card, decided inside the test (never at import): the test
    skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with `python -m "
                    "pytest -m card tests/test_torch_batched_tail.py -s`")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def engine():
    """SF 0.005 on the CPU, with an appended fact tail (capacity-padding
    rows whose foreign keys join nothing) and deleted customer and part
    keys (probe misses, ``dim_row == -1``)."""
    eng = SSBEngine(generate_ssb(0.005, seed=3, device="cpu"), device="cpu")
    rng = np.random.default_rng(4)
    eng.append_fact_rows(generate_fact_batch(eng.tables, 777, rng))
    for dim, key in (("customer", "custkey"), ("part", "partkey")):
        keys = eng.tables[dim][key].numpy()
        eng.ingest(dim, rng.choice(keys, len(keys) // 10, replace=False),
                   op="delete")
    eng.warm_cache()
    return eng


def _operands(engine, name):
    spec = SSB_QUERIES[name]
    fact_cols = dict(engine.tables["lineorder"].columns)
    dim_cols = {d: dict(engine.tables[d].columns)
                for d in spec.joined_dims()}
    probes = {d: engine.probe_dim(d) for d in spec.joined_dims()}
    return fact_cols, dim_cols, probes


def _params(name, width, seed):
    rng = np.random.default_rng(seed)
    return [PARAM_QUERIES[name].sample(rng) for _ in range(width)]


def _hold(name, ps, fact_cols, dim_cols, probes):
    """``_batched_tail`` (the plain version on the CPU) against
    ``_filter_aggregate`` of each bound request, bit for bit."""
    pq = PARAM_QUERIES[name]
    params = torch.as_tensor(np.asarray(ps, np.int32))
    totals, groups = pbatch._batched_tail(pq, fact_cols, dim_cols, probes,
                                         params)
    assert totals.dtype == groups.dtype == torch.int32
    assert groups.shape[0] == totals.shape[0] == len(ps)
    for i, p in enumerate(ps):
        t, g = _filter_aggregate(pq.bind(tuple(p)), fact_cols, dim_cols,
                                 probes)
        assert int(totals[i]) == int(t), (name, p)
        np.testing.assert_array_equal(groups[i].numpy(), g.numpy(),
                                      err_msg=f"{name}{p}")


def test_the_fixture_has_padding_and_misses(engine):
    fact = engine.tables["lineorder"]
    assert fact.n_physical > fact.n_rows
    for dim in ("customer", "part"):
        found, row = engine.probe_dim(dim)
        assert not found[:fact.n_rows].all()
        assert not found[fact.n_rows:].any()
        assert (row[~found] == -1).all()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", NAMES)
def test_plain_equals_filter_aggregate(engine, name, width):
    _hold(name, _params(name, width, 100 * width + NAMES.index(name)),
          *_operands(engine, name))


@pytest.mark.parametrize("name", ["Q1.1", "Q2.1", "Q3.1", "Q4.1", "Q4.3"])
def test_plain_wraps_like_int32(engine, name):
    """Measures near 2^31: the products, differences, totals and segment
    sums all overflow int32 and must wrap as torch's do."""
    fact_cols, dim_cols, probes = _operands(engine, name)
    rng = np.random.default_rng(17)
    n = fact_cols["revenue"].shape[0]
    for col, lo, hi in (("revenue", 2 ** 30, 2 ** 31),
                        ("supplycost", -2 ** 31, -2 ** 30),
                        ("extendedprice", 2 ** 28, 2 ** 31)):
        fact_cols[col] = torch.as_tensor(
            rng.integers(lo, hi, n).astype(np.int32))
    _hold(name, _params(name, 3, 5), fact_cols, dim_cols, probes)


@pytest.mark.parametrize("name", NAMES)
def test_operand_planes_equal_the_lambdas(engine, name, monkeypatch):
    """Bit i of a dimension's word is request i's predicate on that row,
    the group part is the composite key's share, and the fact word holds
    the fact filter's bits, a chunk at a time."""
    pq = PARAM_QUERIES[name]
    spec = SSB_QUERIES[name]
    fact_cols, dim_cols, probes = _operands(engine, name)
    ps = _params(name, 5, 7)
    params = torch.as_tensor(np.asarray(ps, np.int32))
    bound = pq.bind([params[:, j:j + 1] for j in range(params.shape[1])])
    monkeypatch.setattr(bt, "FACT_FILTER_CELLS", 5 * 1000)  # 1000 rows
    dim_ops, fword, measure, size = bt.tail_operands(
        bound, fact_cols, dim_cols, probes, len(ps))
    assert size == int(np.prod([c for _, _, c in spec.group_by] or [1]))
    dims = spec.joined_dims()
    assert len(dim_ops) == len(dims)
    stride = size
    strides = {}
    for dim, col, card in spec.group_by:
        stride //= card
        strides[dim] = (col, card, stride)
    for dim, (found, row, pred, group) in zip(dims, dim_ops):
        assert found is probes[dim][0] and row is probes[dim][1]
        if dim in pq.dim_filters:
            for i, p in enumerate(ps):
                want = pq.dim_filters[dim](dim_cols[dim], p)
                np.testing.assert_array_equal(
                    ((pred >> i) & 1).bool().numpy(), want.numpy())
        else:
            assert pred is None
        if dim in strides:
            col, card, s = strides[dim]
            np.testing.assert_array_equal(
                group.numpy(),
                (np.mod(dim_cols[dim][col].numpy(), card) * s))
        else:
            assert group is None
    if pq.fact_filter is None:
        assert fword is None
    else:
        assert fword.shape == fact_cols["revenue"].shape
        for i, p in enumerate(ps):
            np.testing.assert_array_equal(
                ((fword >> i) & 1).bool().numpy(),
                pq.fact_filter(fact_cols, p).numpy())
    op, a, b = measure
    want = spec.measure(fact_cols)
    got = {0: lambda: a, 1: lambda: a * b, 2: lambda: a - b,
           3: lambda: a + b}[op]()
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_measure_form_traces_the_callables():
    forms = {name: bt.measure_form(SSB_QUERIES[name].measure)
             for name in ("Q1.1", "Q2.1", "Q4.1")}
    assert forms == {"Q1.1": (1, "extendedprice", "discount"),
                     "Q2.1": (0, "revenue", None),
                     "Q4.1": (2, "revenue", "supplycost")}
    assert bt.measure_form(lambda t: t["a"] + t["b"]) == (3, "a", "b")
    for bad in (lambda t: t["a"] * 2, lambda t: t["a"] * t["b"] - t["c"],
                lambda t: 7):
        with pytest.raises(NotImplementedError):
            bt.measure_form(bad)


def test_request_bits_sets_bit_31():
    mask = torch.zeros((32, 5), dtype=torch.bool)
    mask[31, 1] = mask[0, 1] = mask[3, 4] = True
    words = bt.request_bits(mask, bt.request_bit(32, "cpu"))
    assert words.dtype == torch.int32
    assert words.tolist() == [0, -2 ** 31 + 1, 0, 0, 8]
    # a mask that does not depend on the parameters broadcasts
    assert bt.request_bits(torch.tensor([True, False]),
                           bt.request_bit(3, "cpu")).tolist() == [7, 0]


def _registry_case(name):
    from repro_torch.kernels.ops import KERNEL_REGISTRY
    [case] = [c for c in KERNEL_REGISTRY["batched_tail"].make_cases("cpu")
              if c[0] == name]
    return case


@pytest.mark.parametrize("bad", ["no_dims", "five_dims", "requests", "dtype",
                                 "found_dtype", "ragged", "planes", "empty",
                                 "op", "segments", "meta_device",
                                 "fact_ragged"])
def test_wrapper_rejects_bad_operands(bad):
    _, (dim_ops, fword, measure), kw = _registry_case("three_dims_grouped")
    dim_ops = list(dim_ops)
    op, ma, mb = measure
    if bad == "no_dims":
        dim_ops = []
    elif bad == "five_dims":
        dim_ops = dim_ops * 2
    elif bad == "requests":
        kw = dict(kw, n_requests=33)
    elif bad == "dtype":
        ma = ma.long()
    elif bad == "found_dtype":
        f, r, p, g = dim_ops[0]
        dim_ops[0] = (f.to(torch.uint8), r, p, g)
    elif bad == "ragged":
        mb = mb[:-1]
    elif bad == "planes":
        f, r, p, g = dim_ops[2]
        dim_ops[2] = (f, r, p[:-1], g)
    elif bad == "empty":
        f, r, p, g = dim_ops[1]
        dim_ops[1] = (f, r, p[:0], None)
    elif bad == "op":
        op = 0
    elif bad == "segments":
        kw = dict(kw, num_segments=0)
    elif bad == "meta_device":
        dim_ops = [tuple(None if t is None else t.to("meta") for t in ops)
                   for ops in dim_ops]
        ma, mb = ma.to("meta"), mb.to("meta")
    elif bad == "fact_ragged":
        fword = ma[:-1]
    with pytest.raises(ValueError):
        bt.batched_tail(tuple(dim_ops), fword, (op, ma, mb), **kw)


def test_tail_operands_rejects_a_wide_pass(engine):
    fact_cols, dim_cols, probes = _operands(engine, "Q2.1")
    pq = PARAM_QUERIES["Q2.1"]
    params = torch.as_tensor(np.asarray(_params("Q2.1", 33, 1), np.int32))
    spec = pq.bind([params[:, j:j + 1] for j in range(params.shape[1])])
    with pytest.raises(ValueError, match="requests"):
        bt.tail_operands(spec, fact_cols, dim_cols, probes, 33)


def test_cpu_serving_takes_the_plain_version(engine, monkeypatch):
    """On CPU tensors ``run_batch`` builds the kernel's operands once per
    32-request pass and answers through the plain version: no library is
    built or launched, and the answers are ``_filter_aggregate``'s."""
    calls = []
    build = bt.tail_operands
    monkeypatch.setattr(pbatch, "tail_operands",
                        lambda *a: calls.append(a[-1]) or build(*a))
    before = bt.batched_tail.launches
    ps = _params("Q3.1", 35, 2)
    out = BatchRunner().run_batch(engine, "Q3.1", ps, flavor="batch")
    assert calls == [32, 3] and bt.batched_tail.launches == before
    assert _build.loaded() == ()
    fact_cols, dim_cols, probes = _operands(engine, "Q3.1")
    for p, (t, g) in zip(ps, out):
        wt, wg = _filter_aggregate(PARAM_QUERIES["Q3.1"].bind(tuple(p)),
                                   fact_cols, dim_cols, probes)
        assert t == int(wt), p
        np.testing.assert_array_equal(g, wg.numpy())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.card
def test_kernel_equals_plain_on_the_card(card):
    """Every query at widths 1, 3 and 33 over 3M fact rows (SF 0.5), with
    an appended tail and deleted keys: the kernel against its plain
    version and against ``_filter_aggregate``, bit for bit."""
    eng = SSBEngine(generate_ssb(0.5, seed=21, device=card), device=card)
    rng = np.random.default_rng(22)
    eng.append_fact_rows(generate_fact_batch(eng.tables, 12345, rng))
    keys = eng.tables["customer"]["custkey"].cpu().numpy()
    eng.ingest("customer", rng.choice(keys, len(keys) // 20, replace=False),
               op="delete")
    eng.warm_cache()
    for name in NAMES:
        fact_cols, dim_cols, probes = _operands(eng, name)
        pq = PARAM_QUERIES[name]
        for width in WIDTHS:
            ps = _params(name, width, width)
            params = torch.as_tensor(np.asarray(ps, np.int32), device=card)
            before = bt.batched_tail.launches
            totals, groups = pbatch._batched_tail(pq, fact_cols, dim_cols,
                                                 probes, params)
            assert bt.batched_tail.launches - before == -(-width // 32)
            for i in range(0, width, 32):
                part = params[i:i + 32]
                spec = pq.bind([part[:, j:j + 1]
                                for j in range(part.shape[1])])
                ops = bt.tail_operands(spec, fact_cols, dim_cols, probes,
                                       part.shape[0])
                pt, pg = bt.batched_tail_plain(
                    *ops[:3], n_requests=part.shape[0], num_segments=ops[3])
                assert torch.equal(totals[i:i + 32], pt), (name, width)
                assert torch.equal(groups[i:i + 32], pg), (name, width)
            for i in (0, width - 1):
                t, g = _filter_aggregate(pq.bind(tuple(ps[i])), fact_cols,
                                         dim_cols, probes)
                assert int(totals[i]) == int(t), (name, ps[i])
                assert torch.equal(groups[i], g), (name, ps[i])
