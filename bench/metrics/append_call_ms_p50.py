"""``append_call_ms_p50``: the median, by nearest rank, of the writer's span
around each fact append in the window (``append_fact_rows``), from the
call until an event recorded on the card's stream after it had passed
(the append's work and what was queued before it), in ms."""
from bench.stats import nearest_rank


def read(run):
    v = [(w.done - w.start) * 1e3 for w in run.writes
         if w.kind == "fact_append" and w.done is not None]
    return nearest_rank(v, 0.5) if v else None
