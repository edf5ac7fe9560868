"""Wrapper for the coalescing-window CUDA kernel (``csrc/coalesce_window.cu``).

``coalesce_window_mask`` replaces the kernel of the same name in
``repro/kernels/coalesce_window.py``: for an ``(m,)`` int32 probe stream,
the ``(m,)`` bool mask of the probes the RLU's optimization buffer filters
(a repeat of one of the previous ``window - 1`` keys).  Its plain version
is ``core.dedup.windowed_coalesce_mask``: a position before the stream's
start never matches (the reference's oracle and Pallas kernel pre-pad with
two different sentinels instead; see that function).

Dispatch: a CUDA tensor launches the kernel (and raises if it cannot be
built or launched); a CPU tensor takes the plain version.  ``launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.dedup import windowed_coalesce_mask
from repro_torch.kernels import _build

MAX_WINDOW = 32


def coalesce_window_mask_plain(keys: torch.Tensor, *,
                               window: int = 8) -> torch.Tensor:
    """The plain version: ``core.dedup.windowed_coalesce_mask``."""
    return windowed_coalesce_mask(keys, window)


def coalesce_window_mask(keys: torch.Tensor, *,
                         window: int = 8) -> torch.Tensor:
    """(m,) int32 -> (m,) bool: True where the probe is filtered (a repeat
    within the previous ``window - 1`` probes), ``2 <= window <= 32``."""
    if keys.dtype != torch.int32 or keys.dim() != 1 or \
            not keys.is_contiguous():
        raise ValueError(f"coalesce_window_mask: keys must be a contiguous "
                         f"1-D int32 tensor, got {keys.dtype} of shape "
                         f"{tuple(keys.shape)}")
    if not 2 <= window <= MAX_WINDOW:
        raise ValueError(f"coalesce_window_mask: window {window} outside "
                         f"2..{MAX_WINDOW}")
    if keys.device.type == "cpu":
        return coalesce_window_mask_plain(keys, window=window)
    if keys.device.type != "cuda":
        raise ValueError(f"coalesce_window_mask: tensors on {keys.device} "
                         "(CPU tensors take the plain version, CUDA tensors "
                         "the kernel)")
    m = keys.shape[0]
    out = torch.empty(m, dtype=torch.bool, device=keys.device)
    if m == 0:
        return out
    lib = _build.load("coalesce_window")
    _build.check(lib.coalesce_window_mask_launch(
        keys.data_ptr(), out.data_ptr(), m, window,
        torch.cuda.current_stream().cuda_stream), "coalesce_window_mask")
    coalesce_window_mask.launches += 1
    return out


coalesce_window_mask.launches = 0
