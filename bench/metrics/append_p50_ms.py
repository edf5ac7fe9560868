"""``append_p50_ms``: the median, by nearest rank, of the end-to-end latency
of every fact append due in the window: from the time it fell due (its share
of the queries sent) until its calls had returned and their work on the card
was done (``bench.stats.write_latency_ms``)."""
from bench.stats import write_latency_ms


def read(run):
    return write_latency_ms(run, ("fact_append",), 0.5)
