"""Synthetic Zipf token pipeline: the LM data substrate.

PyTorch port of ``repro.data.pipeline``.  Natural-language token
frequencies are Zipfian; sampling synthetic batches from a Zipf(s)
marginal (with short repeated-phrase bursts) yields streams whose
duplication statistics match what the JSPIM dedup-embedding path exploits.
The draws are the reference's numpy draws, so a batch is the reference's
bit for bit.  ``shard_batch`` places a batch on one device, or on a
mesh's device with the reference's dp ``Placement`` (the batch dimension
over the mesh's pod and data axes).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.skew import zipf_weights
from repro_torch.engine.table import resolve_device
from repro_torch.launch.mesh import Placement, ShardMesh, dp_size
from repro_torch.launch.sharding import place


class ZipfTokenStream:
    """Deterministic, seekable synthetic token stream (resume-friendly)."""

    def __init__(self, vocab_size: int, seq_len: int, zipf_s: float = 1.1,
                 burst_len: int = 4, seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.zipf_s = zipf_s
        self.burst_len = burst_len
        self.seed = seed
        self._weights = zipf_weights(vocab_size, zipf_s)

    def batch(self, step: int, batch_size: int) -> dict[str, np.ndarray]:
        """Batch for a given step index (pure function of (seed, step))."""
        rng = np.random.default_rng((self.seed, step))
        n = batch_size * self.seq_len
        draws = rng.choice(self.vocab_size, size=n // self.burst_len + 1,
                           p=self._weights)
        toks = np.repeat(draws, self.burst_len)[:n].astype(np.int32)
        toks = toks.reshape(batch_size, self.seq_len)
        labels = np.roll(toks, -1, axis=1)
        return {"tokens": toks, "labels": labels}

    def batches(self, batch_size: int, start_step: int = 0
                ) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, batch_size)
            step += 1


def shard_batch(batch: dict[str, np.ndarray], mesh: ShardMesh | None,
                microbatches: int = 1, device=None) -> dict[str, torch.Tensor]:
    """Reshape to (microbatches, per, S) and place on the card unless
    ``device`` names another.  With a mesh, each tensor lands on
    ``mesh.device`` carrying ``Placement(mesh, (None, dp, None, ...))``,
    ``dp`` being the mesh's pod and data axes (``device`` is unused); rows
    that do not split over the dp regions raise ``ValueError``, as the
    reference's ``device_put`` does."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        v = v.reshape(microbatches, b // microbatches, *v.shape[1:])
        t = torch.from_numpy(np.ascontiguousarray(v))
        if mesh is None:
            out[k] = t.to(dev)
            continue
        dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        n_dp = dp_size(mesh)
        if v.shape[1] % n_dp:
            raise ValueError(f"{k}: {v.shape[1]} rows per microbatch do "
                             f"not split over the {n_dp} dp regions of "
                             f"{dp}")
        out[k] = place(t, Placement(mesh, (None, dp) + (None,)
                                    * (v.ndim - 2)))
    return out


class Prefetcher:
    """Background-thread prefetch (depth-bounded) over a batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
