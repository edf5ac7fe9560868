"""The card's peaks, and the bytes a probe launch's data needs.

The byte arithmetic is a frozen copy of ``chip_smoke.py``'s: every operand
tensor is read once and the ``(m,)`` int32 words are written once.  A hash
table's planes count whole only when the launch has probes enough to
touch every row; a smaller launch counts what its ``m`` probes can need at
most: one key row and one word of each plane per probe.  For 60,000,000
probes into part's 524,288 x 8 table at SF10 this gives the 513,554,432
bytes of ``probe_rows`` in ``PERF.md``'s kernel table.
"""
from __future__ import annotations

import torch

# Peak HBM bandwidth by ``torch.cuda.get_device_name()``: NVIDIA's data
# sheet for the SXM part at its 700 W limit.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# The probe wrappers of ``repro_torch.kernels.ops`` the benchmark's spans
# wrap, with the positions of their hash-table planes, probe vectors and
# delta planes.
PROBE_WRAPPERS = {
    "probe_rows": {"planes": (0, 1), "vectors": (2,), "delta": ()},
    "bucket_probe_stream": {"planes": (0, 1), "vectors": (2,), "delta": ()},
    "probe_filter_rows": {"planes": (0, 1, 2), "vectors": (3,), "delta": ()},
    "probe_filter_rows_delta": {"planes": (0, 1, 2), "vectors": (3, 7),
                                "delta": (5, 6)},
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _planes_needed(planes: list[torch.Tensor], m: int) -> int:
    whole = sum(_nbytes(p) for p in planes)
    width = planes[0].shape[1]
    per_probe = 4 * width + 4 * (len(planes) - 1)
    return min(whole, m * per_probe)


def probe_launch_bytes(wrapper: str, args: tuple) -> int:
    """Bytes one launch of ``wrapper`` with ``args`` needs moved; 0 when it
    launches nothing (no probes)."""
    spec = PROBE_WRAPPERS[wrapper]
    m = args[spec["vectors"][0]].numel()
    if m == 0:
        return 0
    moved = sum(_nbytes(args[i]) for i in spec["vectors"]) + 4 * m
    moved += _planes_needed([args[i] for i in spec["planes"]], m)
    if spec["delta"]:
        moved += _planes_needed([args[i] for i in spec["delta"]], m)
    return moved
