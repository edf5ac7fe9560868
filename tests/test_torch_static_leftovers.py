"""The static engine's leftovers against the JAX package.

* The sf=0.02 gate: seeds 0 and 3, every port kernel x schedule x fusion x
  ``use_cache``, and the baseline and pid modes, bit-identical to the JAX
  engine on ``kernel="xla"`` (gathered).
* The legacy ``mode=`` / ``probe_impl=`` / ``schedule=`` keywords and
  ``resolve_policy``, a conflicting keyword raising.
* ``run_eager`` (the reference loop), ``baselines.numpy_join_oracle``,
  ``ops.kernel_supported`` and ``ops.probe_table_ref``.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.policy import ExecutionPolicy as JaxPolicy
from repro.core.policy import resolve_policy as jax_resolve_policy
from repro.engine import SSBEngine as JaxEngine
from repro.engine import baselines as jbaselines
from repro.engine import generate_ssb as jax_generate_ssb
from repro.kernels import ops as jops
from repro_torch.core import ExecutionPolicy, resolve_policy
from repro_torch.core.hash_table import EMPTY_KEY, HASH_FIBONACCI, build_table
from repro_torch.engine import SSB_QUERIES, SSBEngine, generate_ssb
from repro_torch.engine.baselines import numpy_join_oracle
from repro_torch.kernels import KERNEL_REGISTRY
from repro_torch.kernels.ops import (kernel_supported, probe_table,
                                     probe_table_ref)

NAMES = sorted(SSB_QUERIES)
GATE_SF = 0.02
GATE_SEEDS = (0, 3)
SCHEDULES = ("gathered", "stream", "deduped", "hot_cold", "auto")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_when_parallel():
    """In a parallel run (pytest-xdist workers share the cores) this
    module's torch ops take one thread each: OpenMP regions, which wait
    for every thread, stall when the cores are oversubscribed.  Alone,
    torch keeps its default."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(answers):
    return {q: (int(t), np.asarray(g)) for q, (t, g) in answers.items()}


def _assert_same(got, want, msg):
    assert sorted(got) == sorted(want) == NAMES
    for q, (total, groups) in want.items():
        assert got[q][0] == total, f"{msg} {q} total"
        np.testing.assert_array_equal(got[q][1], groups,
                                      err_msg=f"{msg} {q}")


_GATE = {}


def _gate(seed):
    """(port tables, the JAX engine's 13 answers) at sf=0.02, ``seed``."""
    if seed not in _GATE:
        jengine = JaxEngine(jax_generate_ssb(GATE_SF, seed=seed),
                            policy=JaxPolicy(kernel="xla",
                                             schedule="gathered"))
        _GATE[seed] = (generate_ssb(GATE_SF, seed=seed, device="cpu"),
                       _np(jengine.run_all(fusion="composed")))
    return _GATE[seed]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("seed", GATE_SEEDS)
def test_sf002_gate(seed, kernel, schedule):
    """Every fusion x ``use_cache`` through ``run_all`` (composed runs
    each query through ``run``; mega shares one probe per dimension)."""
    tables, want = _gate(seed)
    engine = SSBEngine(tables, policy=ExecutionPolicy(
        kernel=kernel, schedule=schedule), device="cpu")
    for fusion in ("composed", "mega"):
        for use_cache in (True, False):
            label = f"seed {seed} {kernel}/{schedule}/{fusion}/{use_cache}"
            _assert_same(_np(engine.run_all(fusion=fusion,
                                            use_cache=use_cache)),
                         want, label)


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("seed", GATE_SEEDS)
def test_sf002_gate_fused_query(seed, kernel):
    """``run(q, fusion="mega")``: one ``fused_query`` a query, which reads
    neither the probe cache nor the schedule, so one engine a kernel
    covers every schedule and ``use_cache``."""
    tables, want = _gate(seed)
    engine = SSBEngine(tables, policy=ExecutionPolicy(kernel=kernel),
                       device="cpu")
    for use_cache in (True, False):
        _assert_same(_np({q: engine.run(q, fusion="mega",
                                        use_cache=use_cache)
                          for q in NAMES}), want,
                     f"seed {seed} {kernel} run mega {use_cache}")


@pytest.mark.parametrize("mode", ["baseline", "pid"])
@pytest.mark.parametrize("seed", GATE_SEEDS)
def test_sf002_gate_join_modes(seed, mode):
    tables, want = _gate(seed)
    engine = SSBEngine(tables, mode, device="cpu")
    for use_cache in (True, False):
        _assert_same(_np(engine.run_all(use_cache=use_cache)), want,
                     f"seed {seed} {mode} {use_cache}")
    _assert_same(_np({q: engine.run_eager(q) for q in NAMES}), want,
                 f"seed {seed} {mode} eager")


@pytest.fixture(scope="module")
def small():
    return generate_ssb(0.002, device="cpu")


def test_legacy_keywords_resolve_into_the_policy(small):
    engine = SSBEngine(small, "baseline", device="cpu")
    assert engine.policy == ExecutionPolicy(mode="baseline")
    engine = SSBEngine(small, probe_impl="torch", schedule="stream",
                       device="cpu")
    assert (engine.mode, engine.probe_impl, engine.schedule) == \
        ("jspim", "torch", "stream")
    assert engine.plans["part"].schedule == "stream"
    policy = ExecutionPolicy(kernel="torch", schedule="deduped")
    engine = SSBEngine(small, "jspim", "torch", "deduped", policy=policy,
                       device="cpu")
    assert engine.policy is policy  # agreeing keywords keep the policy
    assert resolve_policy() == ExecutionPolicy()
    assert resolve_policy(fusion="mega") == ExecutionPolicy(fusion="mega")


@pytest.mark.parametrize("kw", [{"mode": "pid"}, {"probe_impl": "cuda"},
                                {"schedule": "hot_cold"}])
def test_a_conflicting_keyword_raises(small, kw):
    policy = ExecutionPolicy(kernel="torch", schedule="deduped")
    with pytest.raises(ValueError, match="conflicts"):
        SSBEngine(small, policy=policy, device="cpu", **kw)
    with pytest.raises(ValueError, match="conflicts"):
        resolve_policy(policy, **kw)
    # the JAX package refuses the same conflict (its kernel spelling)
    jkw = {k: {"cuda": "pallas"}.get(v, v) for k, v in kw.items()}
    with pytest.raises(ValueError, match="conflicts"):
        jax_resolve_policy(JaxPolicy(kernel="xla", schedule="deduped"),
                           **jkw)


@pytest.mark.parametrize("kw", [{"mode": "sql"}, {"probe_impl": "xla"},
                                {"schedule": "fast"}])
def test_an_unknown_keyword_value_raises(small, kw):
    with pytest.raises(ValueError):
        SSBEngine(small, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["jspim", "baseline", "pid"])
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_run_eager_matches_jax(mode, kernel):
    """The reference loop: no cache (nothing cached afterwards), gathered
    probes whatever the schedule, the JAX engine's answers (its
    ``run_eager`` gives the same; its own tests hold the two equal)."""
    tables, want = _gate(GATE_SEEDS[0])
    engine = SSBEngine(tables, mode, kernel, "hot_cold", device="cpu")
    _assert_same(_np({q: engine.run_eager(q) for q in NAMES}), want,
                 f"{mode} {kernel}")
    assert engine.cache_info()["cached_dims"] == []
    assert engine.cache_info()["misses"] == 0


def test_numpy_join_oracle_matches_jax():
    rng = np.random.default_rng(12)
    for n_f, n_d, hi in ((0, 5, 3), (40, 0, 3), (200, 30, 12),
                         (500, 100, 1000)):
        fk = rng.integers(0, hi, n_f).astype(np.int32)
        dk = rng.integers(0, hi, n_d).astype(np.int32)  # duplicates
        got = numpy_join_oracle(fk, dk)
        assert got == jbaselines.numpy_join_oracle(fk, dk)
        assert got == {(i, j) for i in range(n_f) for j in range(n_d)
                       if fk[i] == dk[j]}


def test_kernel_supported_reports_the_registry():
    for name, op in KERNEL_REGISTRY.items():
        assert kernel_supported(name, "cuda"), name
        assert not kernel_supported(name, "cpu"), name
        assert op.backends == ("cuda",)
    assert not kernel_supported("no_such_kernel", "cuda")
    # as in the JAX package, an unknown kernel reports False
    assert not jops.kernel_supported("no_such_kernel", "cpu")


@pytest.mark.parametrize("mode", ["identity", HASH_FIBONACCI])
def test_probe_table_ref_matches_jax_and_the_kernel_path(mode):
    from repro.core.hash_table import build_table as jax_build_table

    rng = np.random.default_rng(8)
    keys = (np.arange(300, dtype=np.int32) * 7) % 2000
    vals = rng.integers(0, 1 << 20, 300).astype(np.int32)
    table = build_table(torch.as_tensor(keys), torch.as_tensor(vals),
                        num_buckets=128, bucket_width=8, hash_mode=mode)
    jtable = jax_build_table(jnp.asarray(keys), jnp.asarray(vals),
                             num_buckets=128, bucket_width=8, hash_mode=mode)
    probes = rng.integers(0, 2100, 1000).astype(np.int32)
    probes[::9] = EMPTY_KEY
    got = probe_table_ref(table, torch.as_tensor(probes))
    want = jops.probe_table_ref(jtable, jnp.asarray(probes))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, k in zip(got, probe_table(table, torch.as_tensor(probes))):
        assert torch.equal(g, k)
    assert bool(got.found.any()) and not bool(got.found[::9].any())
