"""``device_idle_pct``: the share of the traced window in which no kernel,
copy or set ran on the device (``torch.profiler``'s CUDA activity), in %."""
from bench.tracing import busy_intervals


def read(run):
    if not run.device_events:
        return None
    busy = sum(b - a for a, b in busy_intervals(run.device_events))
    return 100.0 * (1.0 - busy / (run.t_end - run.t0))
