"""What a configuration and a traffic mix ask of a run, checked.

A configuration (``bench/configs/<name>.json``) states the deployment: its
data (``rows``, ``foreign_keys``), the engine's ``ExecutionPolicy``
(``engine``), the scheduler's ``ServeConfig`` (``serve``), its shard count
(``shards``) and its guarantees.  A traffic mix (``bench/traffic/<name>.json``)
states the arrivals, the query ids, the warm-up and the writer.  The
harness honours every key here; a key it does not know, or a value it
cannot run, stops the run before set-up, so a file never asks for
something that the run then quietly leaves out.
"""
from __future__ import annotations

import dataclasses

from bench.reference.ssb import DIM_COLUMNS, QUERY_IDS

# prose and provenance: read by people, not by the run
CONFIG_NOTES = {"name", "source", "scale_factor", "queries", "deployment",
                "reduced", "assumed", "notes"}
CONFIG_KEYS = CONFIG_NOTES | {"rows", "foreign_keys", "engine", "serve",
                              "shards", "guarantees"}
TRAFFIC_KEYS = {"about", "source", "arrivals", "query_ids", "dispatchers",
                "warm_probe_cache", "writer"}
# what the check holds every answer to; a configuration stating another
# guarantee would need another check
GUARANTEES = {"answers": ("exact",), "isolation": ("snapshot",),
              "durability": ("volatile",)}
ARRIVALS = {"closed": {"process", "clients"},
            "poisson": {"process", "rate_per_s", "burst"}}
BURST_KEYS = {"every_s", "for_s", "factor"}
WRITER_KEYS = {"every_queries", "period_ms", "warm_writes", "cycle"}
WRITE_KINDS = {"fact_append": {"kind", "rows_frac"},
               "dim_new_version": {"kind", "dim", "keys_frac", "auto_compact"},
               "dim_delete": {"kind", "dim", "keys_frac", "auto_compact"},
               "compact": {"kind", "dim"}}
SERVE_ALLOWED = {"max_queue", "max_batch", "n_workers", "checkout_timeout_s",
                 "max_retries", "backoff_s", "breaker_threshold",
                 "breaker_cooldown", "serve_maintained",
                 "default_deadline_s"}


def _unknown(where: str, got: dict, known: set) -> None:
    extra = sorted(set(got) - known)
    if extra:
        raise ValueError(f"{where}: unknown key(s) {extra}; known: "
                         f"{sorted(known)}")


def check_config(config: dict) -> None:
    """Raise ``ValueError`` where the configuration asks for what the
    harness does not run."""
    name = f"configuration {config.get('name')!r}"
    _unknown(name, config, CONFIG_KEYS)
    dims = set(DIM_COLUMNS)
    _unknown(f"{name} rows", config["rows"], dims | {"lineorder"})
    missing = sorted((dims | {"lineorder"}) - set(config["rows"]))
    if missing:
        raise ValueError(f"{name}: rows missing {missing}")
    for fk, spec in config["foreign_keys"].items():
        kind = spec.get("dist")
        _unknown(f"{name} foreign key {fk}", spec,
                 {"dist"} | ({"s"} if kind == "zipf" else set()))
    from repro_torch.core.policy import ExecutionPolicy

    fields = {f.name for f in dataclasses.fields(ExecutionPolicy)}
    _unknown(f"{name} engine", config.get("engine", {}), fields)
    _unknown(f"{name} serve", config.get("serve", {}), SERVE_ALLOWED)
    if config.get("shards", 1) != 1:
        raise ValueError(f"{name}: shards {config['shards']}: the harness "
                         "runs one SSBEngine on one card")
    g = config.get("guarantees", {})
    _unknown(f"{name} guarantees", g, set(GUARANTEES))
    for k, allowed in GUARANTEES.items():
        if g.get(k, allowed[0]) not in allowed:
            raise ValueError(
                f"{name}: guarantee {k}={g[k]!r}; the harness runs and "
                f"checks {k} in {list(allowed)} only (a durable engine's "
                "genesis checkpoint alone writes the whole state to disk in "
                "every run)")


def check_traffic(traffic: dict, name: str) -> None:
    """Raise ``ValueError`` where the mix asks for what the generator does
    not draw."""
    where = f"traffic {name!r}"
    _unknown(where, traffic, TRAFFIC_KEYS)
    arr = traffic["arrivals"]
    proc = arr.get("process")
    if proc not in ARRIVALS:
        raise ValueError(f"{where}: arrivals process {proc!r}; known: "
                         f"{sorted(ARRIVALS)}")
    _unknown(f"{where} arrivals", arr, ARRIVALS[proc])
    if proc == "poisson" and arr.get("burst") is not None:
        _unknown(f"{where} burst", arr["burst"], BURST_KEYS)
    bad = sorted(set(traffic.get("query_ids", QUERY_IDS)) - set(QUERY_IDS))
    if bad:
        raise ValueError(f"{where}: unknown query ids {bad}")
    w = traffic.get("writer")
    if w is None:
        return
    _unknown(f"{where} writer", w, WRITER_KEYS)
    if ("every_queries" in w) == ("period_ms" in w):
        raise ValueError(f"{where}: the writer takes one of every_queries "
                         "(a write per that many queries sent) and "
                         "period_ms (open loop)")
    for i, spec in enumerate(w["cycle"]):
        kind = spec.get("kind")
        if kind not in WRITE_KINDS:
            raise ValueError(f"{where} cycle[{i}]: kind {kind!r}; known: "
                             f"{sorted(WRITE_KINDS)}")
        _unknown(f"{where} cycle[{i}]", spec, WRITE_KINDS[kind])


def policy(config: dict):
    """The engine's ``ExecutionPolicy``: the defaults, with the
    configuration's ``engine`` keys."""
    from repro_torch.core.policy import ExecutionPolicy

    return ExecutionPolicy(**config.get("engine", {}))


def serve_config(config: dict):
    """The scheduler's ``ServeConfig``: the defaults, with the
    configuration's ``serve`` keys."""
    from repro_torch.serving import ServeConfig

    return ServeConfig(**config.get("serve", {}))
