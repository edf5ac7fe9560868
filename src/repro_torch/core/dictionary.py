"""Dictionary encoding (JSPIM §3.2.1), PyTorch port of ``repro.core.dictionary``.

The dictionary is a sorted int32 array padded with ``DICT_PAD``: encode is
one ``searchsorted``, decode one gather.  Dense consecutive codes are what
lets the identity hash (low index bits) spread keys evenly over buckets.
``codes`` (an explicit slot -> code map) appears once compaction extends
a dictionary (``extend_dictionary``): existing keys keep their codes, so
the hash table's bucket layout survives.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DICT_PAD = 2**31 - 1   # padding sentinel (sorts after every real key)
NO_CODE = -1           # code returned for keys absent from the dictionary


@dataclasses.dataclass(frozen=True)
class Dictionary:
    """Sorted unique raw keys; a key's code is its sorted rank, or
    ``codes[slot]`` when ``codes`` is present."""

    keys: torch.Tensor                  # (capacity,) int32, DICT_PAD padded
    n: torch.Tensor                     # () int32 live entries
    codes: torch.Tensor | None = None   # (capacity,) int32 code per slot

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def build_dictionary(raw_keys: torch.Tensor, capacity: int) -> Dictionary:
    """Dictionary of an arbitrary (possibly duplicated) key column.

    ``capacity`` must be >= the number of distinct keys; extra slots are
    padded.  Codes are dense 0..n-1 in raw-key sorted order.
    """
    raw_keys = raw_keys.to(torch.int32)
    dev = raw_keys.device
    if raw_keys.shape[0] == 0:
        return Dictionary(
            keys=torch.full((capacity,), DICT_PAD, dtype=torch.int32,
                            device=dev),
            n=torch.tensor(0, dtype=torch.int32, device=dev))
    sk = torch.sort(raw_keys).values
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sk[1:] != sk[:-1]])
    uid = torch.cumsum(is_first, 0) - 1
    # non-first and past-capacity elements land in one trailing slot
    slot = torch.where(is_first & (uid < capacity), uid, capacity)
    out = torch.full((capacity + 1,), DICT_PAD, dtype=torch.int32,
                     device=dev)
    out[slot] = sk
    return Dictionary(keys=out[:capacity],
                      n=is_first.sum().to(torch.int32))


def encode(d: Dictionary, raw_keys: torch.Tensor) -> torch.Tensor:
    """raw key -> dense code (or NO_CODE when absent)."""
    raw_keys = raw_keys.to(torch.int32)
    pos = torch.searchsorted(d.keys, raw_keys)
    pos_c = pos.clamp(max=d.capacity - 1)
    hit = (d.keys[pos_c] == raw_keys) & (pos < d.n)
    code = pos_c.to(torch.int32) if d.codes is None else d.codes[pos_c]
    return torch.where(hit, code, NO_CODE)


def decode(d: Dictionary, codes: torch.Tensor) -> torch.Tensor:
    """dense code -> raw key (DICT_PAD for NO_CODE / out-of-range codes)."""
    codes = codes.to(torch.int32)
    ok = (codes >= 0) & (codes < d.n)
    if d.codes is None:
        key_by_code = d.keys
    else:  # invert the slot -> code permutation
        key_by_code = torch.full((d.capacity + 1,), DICT_PAD,
                                 dtype=torch.int32, device=d.keys.device)
        in_range = (d.codes >= 0) & (d.codes < d.capacity)
        key_by_code[torch.where(in_range, d.codes.long(), d.capacity)] = \
            d.keys
        key_by_code = key_by_code[:d.capacity]
    return torch.where(ok, key_by_code[codes.clamp(0, d.capacity - 1).long()],
                       DICT_PAD)


def extend_dictionary(d: Dictionary, new_keys: np.ndarray
                      ) -> tuple[Dictionary, np.ndarray]:
    """Merge sorted-unique ``new_keys`` (none already present) into ``d``.

    The incremental dictionary maintenance behind delta compaction: an
    O(n + b) positional merge on the host instead of re-sorting the key
    column.  Existing codes are untouched; new keys receive codes
    ``n .. n+b-1`` in their sorted order.  Returns the grown dictionary,
    on ``d``'s device, and the new keys' codes.  Capacity is padded to a
    power of two, as in the JAX package.
    """
    new_keys = np.asarray(new_keys, np.int32)
    b = int(new_keys.shape[0])
    n = int(d.n)
    if b == 0:
        return d, np.zeros((0,), np.int32)
    if not np.all(new_keys[1:] > new_keys[:-1]):
        raise ValueError("new keys must be sorted unique")
    old_keys = d.keys[:n].cpu().numpy()
    old_codes = (np.arange(n, dtype=np.int32) if d.codes is None
                 else d.codes[:n].cpu().numpy())
    new_codes = n + np.arange(b, dtype=np.int32)
    # stable two-way merge positions (the key sets are disjoint)
    pos_old = np.arange(n) + np.searchsorted(new_keys, old_keys)
    pos_new = np.searchsorted(old_keys, new_keys) + np.arange(b)
    cap = max(d.capacity, 1 << (n + b - 1).bit_length())
    keys_out = np.full((cap,), DICT_PAD, np.int32)
    codes_out = np.arange(cap, dtype=np.int32)  # pad slots map to themselves
    keys_out[pos_old] = old_keys
    keys_out[pos_new] = new_keys
    codes_out[pos_old] = old_codes
    codes_out[pos_new] = new_codes
    dev = d.keys.device
    return Dictionary(keys=torch.as_tensor(keys_out, device=dev),
                      n=torch.tensor(n + b, dtype=torch.int32, device=dev),
                      codes=torch.as_tensor(codes_out, device=dev)), new_codes


def encode_np(d: Dictionary, raw_keys: np.ndarray) -> np.ndarray:
    """Host-side ``encode`` (numpy) over a dictionary on any device."""
    raw_keys = np.asarray(raw_keys, np.int32)
    keys = d.keys.cpu().numpy()
    n = int(d.n)
    pos = np.searchsorted(keys, raw_keys)
    pos_c = np.minimum(pos, keys.shape[0] - 1)
    hit = (keys[pos_c] == raw_keys) & (pos < n)
    codes = pos_c if d.codes is None else d.codes.cpu().numpy()[pos_c]
    return np.where(hit, codes, NO_CODE).astype(np.int32)
