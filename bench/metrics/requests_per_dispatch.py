"""``requests_per_dispatch``: requests the scheduler completed in the
window over the dispatches it ran (``QueryScheduler.stats`` ``completed``
and ``batches``, read at the window's start and once every request sent
in it was answered)."""


def read(run):
    a, b = run.stats_start, run.stats_end
    batches = b.get("batches", 0) - a.get("batches", 0)
    if batches <= 0:
        return None
    return (b.get("completed", 0) - a.get("completed", 0)) / batches
