"""``probe_kernels_roofline``: the port's probe kernels' share of their
memory roofline over the traced window, in %.

The numerator sums, over every probe-wrapper call the benchmark's spans
saw in the window (``probe_rows``, ``bucket_probe_stream``,
``probe_filter_rows``, ``probe_filter_rows_delta``), the bytes its data
needs (``bench/kernels.py``) over the card's peak HBM bandwidth.  The
denominator is the device time of those kernels in the profiler's trace:
``rows_kernel``, ``table_kernel``, ``stream_ring_kernel``,
``filter_kernel``, ``filter_smem_kernel`` and the filter kernels' packing
launches (the templated ``pack_kernel``).  Nothing to read where no probe
kernel ran.
"""
import re

from bench.kernels import HBM_BYTES_PER_S

PROBE_KERNEL = re.compile(
    r"^(?:void )?\(anonymous namespace\)::(?:(?:rows_kernel|table_kernel|"
    r"stream_ring_kernel|filter_kernel|filter_smem_kernel)\b|pack_kernel<)")


def read(run):
    peak = HBM_BYTES_PER_S.get(run.device_kind)
    if not run.device_events or peak is None:
        return None
    moved = sum(s.attrs.get("bytes", 0) for s in run.spans.named("kernel.")
                if run.t0 <= s.start < run.t_end)
    busy = sum(e.end - e.start for e in run.device_events
               if PROBE_KERNEL.match(e.name))
    if moved <= 0 or busy <= 0:
        return None
    return 100.0 * (moved / peak) / busy
