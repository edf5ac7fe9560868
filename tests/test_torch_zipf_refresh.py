"""The skewed SSB deployment (``bench/configs/ssb_sf30_zipf1.json``: Zipf(1.0)
customer, part and supplier keys) at a CPU size, under the refresh mix.

An ``SSBEngine`` with the configuration's policy is built on the tables the
benchmark draws from a seed, and a ``QueryScheduler`` serves requests
between the writes of one whole refresh cycle (``bench/traffic/refresh.json``:
fact appends, new dimension row versions and deletes).  Then the fact-side
skew is measured again (forced), and the 13 queries are asked once more.
Every answer must equal the plain reference's (``bench/reference``), which
replays the writer's log to the epoch the answer reports, exactly.
"""
import json
from pathlib import Path

import numpy as np
import torch

from bench import deploy
from bench.datagen import DataGen, WriteGen, sub_seed
from bench.harness import Writer
from bench.reference.compare import Answer, compare
from bench.reference.replay import Replay
from bench.reference.ssb import QUERY_IDS, TEMPLATES
from repro_torch.engine import SSBEngine, Table
from repro_torch.serving import QueryScheduler

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "bench" / "configs" / "ssb_sf30_zipf1.json")
                    .read_text())
CYCLE = json.loads((ROOT / "bench" / "traffic" / "refresh.json")
                   .read_text())["writer"]["cycle"]
# SF 0.01 (part at 200,000 x SF: SSB's log2 factor is below 1 there)
ROWS = {"lineorder": 60_000, "customer": 300, "supplier": 20, "part": 2_000,
        "date": 2556}
SEED = 2 ** 31 + 2929
PER_WRITE = 2      # requests served before each write


def test_skewed_refresh_answers_equal_the_reference():
    config = {**CONFIG, "rows": ROWS}
    dev = torch.device("cpu")
    data = DataGen(config, SEED, dev)
    fact, dims = data.tables()
    tables = {"lineorder": Table(fact), **{d: Table(c)
                                           for d, c in dims.items()}}
    engine = SSBEngine(tables, policy=deploy.policy(config), device=dev)
    engine.warm_cache()
    # Zipf(1.0) over 300 customers: the hottest holds 1 / H(300) ~ 16%
    assert engine.indexes["customer"].stats.fact_skew.max_share > 0.1
    writer, writes = Writer(engine, dev), WriteGen(data)
    sched = QueryScheduler(engine, deploy.serve_config(config))
    rng = np.random.default_rng(sub_seed(SEED, "requests"))
    asked = []

    def serve(names):
        tickets = [(n, p, sched.submit(n, p)) for n, p in
                   ((n, TEMPLATES[n].sample(rng)) for n in names)]
        sched.pump()
        asked.extend(tickets)

    try:
        for i, spec in enumerate(CYCLE):
            serve([str(n) for n in rng.choice(QUERY_IDS, PER_WRITE)])
            writer.apply(writes.make(i, spec))
        measured = engine.fact_append_info()["skew_measures"]
        engine._maybe_replan_fact_skew(force=True)
        assert engine.fact_append_info()["skew_measures"] == measured + 4
        serve(QUERY_IDS)
    finally:
        sched.close()
    assert [e.op for e in writer.log].count("fact_append") == \
        [s["kind"] for s in CYCLE].count("fact_append")
    answers = []
    for name, params, ticket in asked:
        r = ticket.response
        assert r is not None and r.status == "ok", (name, params)
        answers.append(Answer(name, params, r.epoch, r.total, r.groups))
    assert answers[-1].epoch == engine.epoch == writer.log[-1].epoch
    fact, dims = DataGen(config, SEED, dev).tables()
    verdict = compare(answers, Replay(fact, dims, writer.log))
    assert verdict["compared"] == len(CYCLE) * PER_WRITE + len(QUERY_IDS)
    assert verdict["wrong"] == 0, verdict["examples"]
