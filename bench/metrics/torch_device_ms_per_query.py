"""``torch_device_ms_per_query``: device time of the plain-PyTorch kernels
in the traced window, in ms, over the requests answered ``ok`` in it.

Every kernel counts that is not one of the port's own: those live in an
anonymous namespace of ``repro_torch/kernels/csrc/*.cu`` and are named
``rows_kernel``, ``table_kernel``, ``stream_ring_kernel``,
``filter_kernel``, ``filter_smem_kernel`` (the probe kernels),
``pack_kernel`` (the filter kernels' and ``fused_query``'s packing
launches), ``query_kernel`` (``fused_query``) and ``window_kernel``
(``coalesce_window_mask``).  Copies and sets do not count.  These are the
query tails (``_filter_aggregate``, ``_batched_tail``); in a cell with
writes the write path's plain-PyTorch work (overlay, compaction, append
copies) counts too, over the same requests.
"""
import re

PORT_KERNEL = re.compile(
    r"^(?:void )?\(anonymous namespace\)::(rows_kernel|table_kernel|"
    r"stream_ring_kernel|filter_kernel|filter_smem_kernel|pack_kernel|"
    r"query_kernel|window_kernel)\b")


def read(run):
    if not run.device_events:
        return None
    ok = run.ok_in_window()
    if not ok:
        return None
    s = sum(e.end - e.start for e in run.device_events
            if not e.name.startswith(("Memcpy", "Memset"))
            and not PORT_KERNEL.match(e.name))
    return s * 1e3 / ok
