"""Baseline join implementations the paper compares against.

PyTorch port of ``repro.engine.baselines``' PK joins:

* ``sort_merge_join_unique``       -- sort the dimension keys, binary-search
                                      every fact key.
* ``partitioned_hash_join_unique`` -- PID-Join-style: radix-partition both
                                      sides first (the passes the paper calls
                                      pure overhead on PIM), then probe.

Both return ``(found, dim_row)`` per fact row, ``dim_row == -1`` on a miss.
``numpy_join_oracle`` is the general (duplicates allowed) host oracle.
"""
from __future__ import annotations

import numpy as np
import torch


def sort_merge_join_unique(fact_keys: torch.Tensor, dim_keys: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """PK join (dim keys unique): returns (found, dim_row) per fact row."""
    sk, order = torch.sort(dim_keys, stable=True)
    pos = torch.searchsorted(sk, fact_keys).clamp(max=sk.shape[0] - 1)
    found = sk[pos] == fact_keys
    return found, torch.where(found, order[pos].to(torch.int32), -1)


def partitioned_hash_join_unique(fact_keys: torch.Tensor,
                                 dim_keys: torch.Tensor,
                                 num_partitions: int = 16
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """PID-style partitioned join (PK dims).  Same output as the sort-merge
    join; structurally it performs the radix partition passes."""
    mask = num_partitions - 1
    # partition pass (the data movement PID pays)
    f_ord = torch.sort(fact_keys & mask, stable=True).indices
    d_ord = torch.sort(dim_keys & mask, stable=True).indices
    fk = fact_keys[f_ord].to(torch.int64)
    dk = dim_keys[d_ord].to(torch.int64)
    # partition bits are the low key bits, so a sorted probe of the
    # (partition, key) composite equals per-partition probing
    sd, d_ord2 = torch.sort(dk, stable=True)
    pos = torch.searchsorted(sd, fk).clamp(max=sd.shape[0] - 1)
    found_s = sd[pos] == fk
    row_s = torch.where(found_s, d_ord[d_ord2[pos]].to(torch.int32), -1)
    # un-permute to fact order
    found = torch.zeros_like(found_s)
    found[f_ord] = found_s
    row = torch.full_like(row_s, -1)
    row[f_ord] = row_s
    return found, row


def numpy_join_oracle(fact_keys: np.ndarray,
                      dim_keys: np.ndarray) -> set[tuple[int, int]]:
    """All (fact_row, dim_row) match pairs: general (duplicates allowed)."""
    out: set[tuple[int, int]] = set()
    by_key: dict[int, list[int]] = {}
    for j, k in enumerate(np.asarray(dim_keys).tolist()):
        by_key.setdefault(k, []).append(j)
    for i, k in enumerate(np.asarray(fact_keys).tolist()):
        for j in by_key.get(k, ()):
            out.add((i, j))
    return out
