"""``dim_write_call_ms_p50``: the median, by nearest rank, of the writer's span
around each dimension change in the window (``append_rows`` then an
upserting ``ingest``, or a deleting ``ingest``, with any compaction they
trigger), from the call until an event recorded on the card's stream
after it had passed, in ms."""
from bench.stats import DIM_WRITES, nearest_rank


def read(run):
    v = [(w.done - w.start) * 1e3 for w in run.writes
         if w.kind in DIM_WRITES and w.done is not None]
    return nearest_rank(v, 0.5) if v else None
