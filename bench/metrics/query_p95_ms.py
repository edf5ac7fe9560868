"""``query_p95_ms``: the 95th percentile, by nearest rank, of the latency of
every query request sent in the window, from ``submit`` to the response,
on the host clock.  A request not answered ``ok`` counts as infinitely
late; if that reaches the percentile the reader returns nothing."""
import math

from bench.stats import nearest_rank


def read(run):
    lat = [(r.done - r.sent) * 1e3
           if r.status == "ok" and r.done is not None else math.inf
           for r in run.in_window()]
    if not lat:
        return None
    v = nearest_rank(lat, 0.95)
    return v if math.isfinite(v) else None
