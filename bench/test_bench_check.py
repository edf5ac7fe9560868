"""The check that decides ``correct``: sound runs pass it; the control (the
reference in the system's place, summing in float32) and each fault a
cell can have fail it.

These drive the whole run of a cell on the CPU at SF 0.01, past the
command's look for a card, and of one more: the refresh mix on the Zipf
configuration, which has no cell yet.  ``test_control_fails_on_the_card``
runs the control at each cell's own size on three seeds (``-m card``).
"""
import time

import pytest

from bench import harness

TINY = {"lineorder": 60_000, "customer": 300, "supplier": 20, "part": 2_000,
        "date": 2556}
CELLS = ("ssb30_read", "ssb30_refresh", "ssb30z_refresh")
REFRESH = ("ssb30_refresh", "ssb30z_refresh")
SEED = 2 ** 31 + 77
# the Zipf configuration's refresh, run here on the CPU only
ZIPF = {"name": "ssb_sf30_zipf1", "file": "bench/configs/ssb_sf30_zipf1.json"}
ZIPF_CELL = {"name": "ssb30z_refresh", "config": "ssb_sf30_zipf1",
             "traffic": "refresh", "chips": 1}


def with_zipf(bench):
    return {**bench, "configs": bench["configs"] + [ZIPF],
            "workloads": bench["workloads"] + [ZIPF_CELL]}


def run_tiny(workload, seed=SEED, seconds=0.8, **kw):
    bench = with_zipf(harness.load_benchmark())
    return harness.run_cell(bench, workload, seed, seconds, False,
                            device="cpu", t_start=time.perf_counter(),
                            rows=TINY, log=lambda *a: None, **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, few_threads):
    out = run_tiny(workload)
    assert out["result"]["correct"], out["checks"]
    ok = sum(r.status == "ok" for r in out["run"].in_window())
    assert out["checks"]["answers_compared"]["value"] == \
        min(ok, harness.CHECK_SAMPLE) > 0
    assert list(out["result"])[-1] == "checks"
    if workload in REFRESH:
        assert out["run"].writes and all(w.done for w in out["run"].writes)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, few_threads):
    out = run_tiny(workload, control=True)
    assert not out["result"]["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


def _unchanged_state(engine, sched):
    """Every write returns with the engine's state unchanged."""
    engine.append_fact_rows = lambda rows, **k: {"appended": 0}
    engine.append_rows = lambda dim, rows, **k: None
    engine.ingest = lambda dim, keys, payloads=None, **k: None


def _half_the_rows(engine, sched):
    """The batched tail sums half of the fact rows and doubles the sum."""
    import repro_torch.serving.batch as batch

    whole = batch._batched_tail

    def half(pq, fact_cols, dim_cols, probes, params):
        n = next(iter(fact_cols.values())).shape[0] // 2
        t, g = whole(pq, {k: v[:n] for k, v in fact_cols.items()}, dim_cols,
                     {d: (f[:n], r[:n]) for d, (f, r) in probes.items()},
                     params)
        return t * 2, g * 2

    batch._batched_tail = half
    return lambda: setattr(batch, "_batched_tail", whole)


def _altered_answer(engine, sched):
    """One answer of each dispatch is off by one where it is made."""
    run_batch = sched.runner.run_batch

    def altered(*a, **k):
        out = run_batch(*a, **k)
        total, groups = out[0]
        return [(total + 1, groups)] + out[1:]

    sched.runner.run_batch = altered


FAULTS = [(w, f) for w in CELLS
          for f in (_half_the_rows, _altered_answer)] + \
    [(w, _unchanged_state) for w in REFRESH]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_each_fault_is_not_correct(workload, fault, few_threads):
    undo = []

    def plant(engine, sched):
        u = fault(engine, sched)
        if u is not None:
            undo.append(u)

    try:
        out = run_tiny(workload, plant=plant)
    finally:
        for u in undo:
            u()
    assert not out["result"]["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("workload", ("ssb30_read", "ssb30_refresh"))
def test_control_fails_on_the_card(workload, card):
    """The control at the cell's own size and load, on three seeds: its
    wrong answers are the check's upper reading."""
    bench = harness.load_benchmark()
    for seed in (2 ** 31 + 1001, 2 ** 31 + 1002, 2 ** 31 + 1003):
        out = harness.run_cell(bench, workload, seed, 10.0, False,
                               device=card, t_start=time.perf_counter(),
                               control=True)
        c = out["checks"]
        print(f"[control] {workload} seed {seed}: "
              f"wrong {c['wrong_answers']['value']} of "
              f"{c['answers_compared']['value']}")
        assert not out["result"]["correct"]
        assert c["wrong_answers"]["value"] > 0
