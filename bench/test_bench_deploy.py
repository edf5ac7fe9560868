"""What a configuration or a traffic mix asks for is run, or refused.

The keys of ``bench/configs/*.json`` and ``bench/traffic/*.json`` reach the
system (the engine's policy, the scheduler's knobs, the arrivals, the
writer's schedule), and a key or value the harness does not run stops the
run before set-up.  The runs here are on the CPU at SF 0.01.
"""
import copy
import json
import time

import pytest

from bench import deploy, harness
from bench.test_bench_check import SEED, TINY

BENCH = harness.ROOT / "bench"


def _config():
    return json.loads((BENCH / "configs" / "ssb_sf30.json").read_text())


def _traffic(name="refresh"):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def test_every_file_here_passes_its_check():
    for f in (BENCH / "configs").glob("*.json"):
        deploy.check_config(json.loads(f.read_text()))
    for f in (BENCH / "traffic").glob("*.json"):
        deploy.check_traffic(json.loads(f.read_text()), f.stem)


@pytest.mark.parametrize("edit,needle", [
    (lambda c: c.update(replicas=2), "unknown key"),
    (lambda c: c["engine"].update(prefetch=True), "engine"),
    (lambda c: c["serve"].update(max_inflight=4), "serve"),
    (lambda c: c.update(shards=4), "shards"),
    (lambda c: c["guarantees"].update(durability="durable"), "durability"),
    (lambda c: c["guarantees"].update(isolation="read_committed"),
     "isolation"),
    (lambda c: c["foreign_keys"]["custkey"].update(s=1.5), "custkey"),
    (lambda c: c["rows"].pop("part"), "rows missing"),
])
def test_a_config_key_the_harness_does_not_run_is_refused(edit, needle):
    c = _config()
    edit(c)
    with pytest.raises(ValueError, match=needle):
        deploy.check_config(c)


@pytest.mark.parametrize("edit,needle", [
    (lambda t: t.update(think_time_ms=5), "unknown key"),
    (lambda t: t["arrivals"].update(process="bursty"), "process"),
    (lambda t: t["arrivals"].update(rate_per_s=3), "arrivals"),
    (lambda t: t.update(query_ids=["Q9.9"]), "query ids"),
    (lambda t: t["writer"].update(period_ms=250), "one of"),
    (lambda t: t["writer"]["cycle"].append({"kind": "truncate"}), "kind"),
    (lambda t: t["writer"]["cycle"][0].update(dim="part"), "cycle"),
])
def test_a_traffic_key_the_generator_does_not_draw_is_refused(edit, needle):
    t = _traffic()
    edit(t)
    with pytest.raises(ValueError, match=needle):
        deploy.check_traffic(t, "refresh")


def test_engine_and_serve_keys_reach_the_system():
    c = _config()
    c["engine"] = {"kernel": "torch", "fusion": "composed"}
    c["serve"] = {"max_batch": 4, "n_workers": 1}
    pol, cfg = deploy.policy(c), deploy.serve_config(c)
    assert (pol.kernel, pol.fusion, pol.schedule) == ("torch", "composed",
                                                      "auto")
    assert (cfg.max_batch, cfg.n_workers, cfg.max_queue) == (4, 1, 64)


def test_arrival_times_follow_the_rate_and_bursts():
    flat = harness.arrival_times(5, {"process": "poisson",
                                     "rate_per_s": 200.0}, 10.0)
    assert flat == harness.arrival_times(5, {"process": "poisson",
                                             "rate_per_s": 200.0}, 10.0)
    assert 1800 < len(flat) < 2200 and flat == sorted(flat)
    burst = harness.arrival_times(5, {
        "process": "poisson", "rate_per_s": 200.0,
        "burst": {"every_s": 2.0, "for_s": 0.5, "factor": 4.0}}, 10.0)
    inside = sum(1 for t in burst if t % 2.0 < 0.5)
    assert inside > 2 * (len(burst) - inside) / 3   # 4x the rate a quarter


def _tiny_root(tmp_path, config, traffic):
    """A checkout with the given configuration and traffic files, the
    benchmark's own metric readers, and one cell of them."""
    (tmp_path / "bench" / "configs").mkdir(parents=True)
    (tmp_path / "bench" / "traffic").mkdir()
    (tmp_path / "bench" / "metrics").symlink_to(BENCH / "metrics")
    (tmp_path / "bench" / "configs" / "c.json").write_text(json.dumps(config))
    (tmp_path / "bench" / "traffic" / "t.json").write_text(json.dumps(traffic))
    bench = copy.deepcopy(harness.load_benchmark())
    bench["configs"] = [{"name": "c", "file": "bench/configs/c.json"}]
    bench["workloads"] = [{"name": "cell", "config": "c", "traffic": "t",
                           "chips": 1}]
    return bench


def _run(tmp_path, config, traffic, plant=None, seconds=0.8):
    bench = _tiny_root(tmp_path, config, traffic)
    return harness.run_cell(bench, "cell", SEED, seconds, False,
                            device="cpu", t_start=time.perf_counter(),
                            root=tmp_path, rows=TINY, plant=plant,
                            log=lambda *a: None)


def test_the_engine_runs_the_configured_policy(tmp_path, few_threads):
    c = _config()
    c["engine"] = {"kernel": "torch", "fusion": "composed"}
    seen = {}

    def plant(engine, sched):
        seen["policy"] = engine.policy

    out = _run(tmp_path, c, _traffic("read"), plant)
    assert out["result"]["correct"], out["checks"]
    assert (seen["policy"].kernel, seen["policy"].fusion) == ("torch",
                                                              "composed")


def test_open_loop_arrivals_are_sent_on_schedule(tmp_path, few_threads):
    t = _traffic("read")
    t["arrivals"] = {"process": "poisson", "rate_per_s": 40.0}
    out = _run(tmp_path, _config(), t, seconds=1.0)
    assert out["result"]["correct"], out["checks"]
    sent = out["run"].in_window()
    assert sent == sorted(sent, key=lambda r: r.sent)
    assert len(sent) == len(harness.arrival_times(SEED, t["arrivals"], 1.0))
    assert all(r.done >= r.sent for r in sent)


def test_writes_fall_due_by_the_queries_sent(tmp_path, few_threads):
    out = _run(tmp_path, _config(), _traffic("refresh"), seconds=1.0)
    assert out["result"]["correct"], out["checks"]
    run = out["run"]
    sent = sorted(r.sent for r in run.in_window())
    every = _traffic("refresh")["writer"]["every_queries"]
    assert len(run.writes) == len(sent) // every > 0
    for i, w in enumerate(run.writes):
        assert w.due == sent[(i + 1) * every - 1]


def test_a_compaction_in_the_cycle_keeps_answers_exact(tmp_path,
                                                        few_threads):
    t = _traffic("refresh")
    t["writer"]["cycle"] = [
        {"kind": "dim_new_version", "dim": "part", "keys_frac": 0.01,
         "auto_compact": False},
        {"kind": "dim_delete", "dim": "customer", "keys_frac": 0.01,
         "auto_compact": False},
        {"kind": "compact", "dim": "part"}]
    t["writer"]["every_queries"] = 2
    out = _run(tmp_path, _config(), t, seconds=1.0)
    assert out["result"]["correct"], out["checks"]
    assert {w.kind for w in out["run"].writes} >= {"dim_new_version",
                                                   "compact"}


def test_an_open_loop_writer_falls_due_by_the_clock(tmp_path, few_threads):
    t = _traffic("refresh")
    del t["writer"]["every_queries"]
    t["writer"]["period_ms"] = 200
    out = _run(tmp_path, _config(), t, seconds=1.0)
    assert out["result"]["correct"], out["checks"]
    run = out["run"]
    assert [round(w.due - run.t0, 6) for w in run.writes] == \
        [0.0, 0.2, 0.4, 0.6, 0.8]
