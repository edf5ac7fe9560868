"""Embedding lookup with JSPIM dedup-gather, and the chunked LM-head loss.

PyTorch port of ``repro.models.embedding``.  Natural-language token streams
are Zipf-skewed — exactly the probe-key distribution the paper's coalescing
window exploits.  ``embed_tokens`` with ``dedup=True`` coalesces the
per-batch token stream (``core.dedup.coalesce``: a fixed-capacity unique),
gathers only the distinct rows, and scatters results back through the
inverse permutation (the duplication-list inverse).  Both paths gather the
same rows, so they agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.dedup import coalesce
from repro_torch.launch.sharding import constrain


def embed_tokens(table: torch.Tensor, ids: torch.Tensor, *,
                 dedup: bool = True,
                 unique_capacity: int | None = None) -> torch.Tensor:
    """table: (V, D); ids: (B, S) -> (B, S, D)."""
    v, d = table.shape
    b, s = ids.shape
    if not dedup:
        return constrain(table[ids.long()], "dp", None, "tp")
    n = b * s
    cap = unique_capacity or min(v, n)
    co = coalesce(ids.reshape(-1), cap, pad=0)
    rows = table[torch.clamp(co.unique, 0, v - 1).long()]   # (U, D) gather
    rows = constrain(rows, None, "tp")
    # with cap = min(V, B*S) the coalesce cannot overflow
    out = rows[co.inverse.long()].reshape(b, s, d)
    return constrain(out, "dp", None, "tp")


def lm_head_loss_chunked(h: torch.Tensor, w: torch.Tensor,
                         labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean cross-entropy with sequence-chunked logits.

    h: (B, S, D); w: (D, V); labels: (B, S) — logits (B, chunk, V) are
    materialized one chunk at a time.
    """
    b, s, d = h.shape
    chunk = min(chunk, s)
    while s % chunk:  # largest divisor <= requested chunk
        chunk -= 1
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, chunk):
        logits = (h[:, lo:lo + chunk] @ w).float()           # (B, chunk, V)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, lo:lo + chunk, None].long())[..., 0]
        total = total + (logz - gold).sum()
    return total / (b * s)
