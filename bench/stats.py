"""Order statistics for the metric readers."""
from __future__ import annotations

import math


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least a share ``q`` of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q * len(v)) - 1)]


# the write kinds that change a dimension's rows (a ``compact`` folds a
# delta and changes none)
DIM_WRITES = ("dim_new_version", "dim_delete")


def write_latency_ms(run, kinds, q: float) -> float | None:
    """The ``q`` quantile, by nearest rank, of the latency of every write of
    ``kinds`` due in the window, from the time it was due until its calls
    had returned and an event recorded on the card's stream after them had
    passed.  A write that failed counts as infinitely late; where that
    reaches the quantile, or no such write was due, there is no value."""
    lat = [(w.done - w.due) * 1e3 if w.done is not None else math.inf
           for w in run.writes if w.kind in kinds]
    if not lat:
        return None
    v = nearest_rank(lat, q)
    return v if math.isfinite(v) else None
