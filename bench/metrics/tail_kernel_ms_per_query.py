"""``tail_kernel_ms_per_query``: device time of the hand-written query-tail
kernel in the traced window, in ms, over the requests answered ``ok`` in it.

The kernel is ``batched_tail_kernel`` of
``repro_torch/kernels/csrc/batched_tail.cu``, one launch a dispatch of up to
32 requests, a template over the width it was built for: every profiler
event whose name holds ``batched_tail_kernel<`` counts.  Its operands
(built in plain PyTorch), the readback and every other kernel stay out:
``torch_device_ms_per_query`` counts those beside it.  Nothing to read
where no request was answered or the trace holds no launch of the kernel.
"""
import re

TAIL_KERNEL = re.compile(r"\bbatched_tail_kernel<")


def read(run):
    if not run.device_events:
        return None
    ok = run.ok_in_window()
    if not ok:
        return None
    times = [e.end - e.start for e in run.device_events
             if TAIL_KERNEL.search(e.name)]
    return sum(times) * 1e3 / ok if times else None
