"""Test harness config.

Smoke tests and benches must see exactly ONE device — XLA_FLAGS is NOT set
here (the 512-device override lives only in launch/dryrun.py and the
subprocess-based sharding tests).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import warnings

import pytest

try:
    from hypothesis import HealthCheck, settings
except ModuleNotFoundError:  # container image ships without hypothesis
    import os.path
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _hypothesis_fallback import install

    install()
    from hypothesis import HealthCheck, settings

warnings.filterwarnings("ignore", category=UserWarning)
warnings.filterwarnings("ignore", category=DeprecationWarning)

settings.register_profile(
    "ci", max_examples=25, deadline=None,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
settings.load_profile("ci")


def pytest_configure(config):
    # CI shards tier-1 into parallel jobs: `-m "not slow"` (fast) and
    # `-m slow` (heavy Zipf / sharded-subprocess / property suites).
    # A bare `pytest -x -q` still runs everything (the tier-1 contract).
    config.addinivalue_line(
        "markers",
        "slow: heavy Zipf/sharded/property suites (CI runs them in a "
        "separate parallel shard)")
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def rng():
    import numpy as np
    return np.random.default_rng(0)


@pytest.fixture
def count_lowerings():
    """Shared recompile-count assertion harness.

    Yields jax's ``count_jit_and_pmap_lowerings`` context-manager factory:
    ``with count_lowerings() as n: ...; assert n[0] == 0``.  The zero-
    retrace contracts this guards (steady-state fact appends since PR 4,
    epoch-snapshot swaps since PR 5) share one requirement: nothing that
    changes per event — batch content, epoch counters, snapshot identity —
    may ever become a jit-static argument or mint a new array shape.
    """
    from jax._src import test_util as jtu
    return jtu.count_jit_and_pmap_lowerings


@pytest.fixture(scope="session")
def fact_batch():
    """New lineorder rows resampled from a live fact table's logical rows,
    with optional FK overrides biased into a given key pool (shared by
    the ingest and differential fact-append suites)."""
    import numpy as np

    def make(tables, rng, n_new, start_key, fk_overrides=None, bias=0.4):
        lo = tables["lineorder"]
        src = rng.integers(0, lo.n_rows, n_new)
        cols = {k: np.asarray(lo[k])[:lo.n_rows][src] for k in lo.names()}
        cols["orderkey"] = np.arange(start_key, start_key + n_new,
                                     dtype=np.int32)
        for col, vals in (fk_overrides or {}).items():
            pick = rng.random(n_new) < bias
            cols[col] = np.where(pick, rng.choice(vals, n_new),
                                 cols[col]).astype(np.int32)
        return cols

    return make
