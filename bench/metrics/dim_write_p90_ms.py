"""``dim_write_p90_ms``: the 90th percentile, by nearest rank, of the end-
to-end latency of every dimension change due in the window: from the time it
fell due (its share of the queries sent) until its calls had returned and
their work on the card was done (``bench.stats.write_latency_ms``)."""
from bench.stats import DIM_WRITES, write_latency_ms


def read(run):
    return write_latency_ms(run, DIM_WRITES, 0.9)
