"""Batched serving engine: prefill + greedy decode loop.

PyTorch port of ``repro.serve.engine``.  ``serve_step`` (one new token
against a deep KV cache) is ``decode_step``, which writes the caches in
place (the reference donates them to a jitted step).  The engine shows the
JSPIM integrations end to end: dedup-embedding on the (skewed) batch token
stream and a JSPIM page table for KV paging.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.engine.table import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (ParamTree, decode_step,
                                            init_caches, prefill)
from repro_torch.serve.paged_kv import PageTable


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, caches, token, pos) -> (logits, caches)."""
    def serve_step(params, caches, token, pos):
        return decode_step(cfg, params, caches, token, pos)
    return serve_step


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor   # (B, steps)
    steps: int


class Server:
    """Static-batch greedy server with paged-KV bookkeeping, on the card
    unless ``device`` names another (the parameters must live there)."""

    def __init__(self, cfg: ModelConfig, params: ParamTree, max_seq: int,
                 batch: int, page_size: int = 256, device=None):
        self.device = resolve_device(device)
        where = next(params.parameters()).device
        if where != self.device:
            raise ValueError(f"the parameters are on {where}, the server "
                             f"on {self.device}")
        self.cfg, self.params = cfg, params
        self.max_seq, self.batch = max_seq, batch
        self.serve_step = make_serve_step(cfg)
        self.pages = PageTable(
            n_physical=batch * max(1, max_seq // page_size) + 8,
            max_pages_per_seq=max(1, max_seq // page_size),
            device=self.device)
        self.page_size = page_size

    @torch.no_grad()
    def generate(self, prompts: torch.Tensor, steps: int,
                 image_embeds=None) -> GenerationResult:
        b, s = prompts.shape
        if b != self.batch:
            raise ValueError(f"{b} prompts for a batch of {self.batch}")
        prompts = prompts.to(self.device)
        # page bookkeeping for the prompt
        for seq in range(b):
            for pg in range((s + self.page_size - 1) // self.page_size):
                self.pages.alloc(seq, pg)
        logits, caches = prefill(self.cfg, self.params, prompts,
                                 max_seq=self.max_seq,
                                 image_embeds=image_embeds)
        # merge prefill caches into full-length decode caches
        full = init_caches(self.cfg, b, self.max_seq,
                           self.cfg.n_image_tokens, device=self.device)
        merged = []
        for (mixer, _), pc, fc in zip(self.cfg.pattern, caches, full):
            if mixer == "attn":
                for dst, src in zip(fc, pc):
                    dst[:, :, :src.shape[2]] = src
                merged.append(fc)
            else:
                merged.append(pc)
        caches = merged
        out = []
        tok = torch.argmax(logits, dim=-1)[:, None]
        for t in range(steps):
            pos = s + t
            # allocate a page when a sequence crosses a page boundary
            if pos % self.page_size == 0:
                for seq in range(b):
                    self.pages.alloc(seq, pos // self.page_size)
            out.append(tok)
            logits, caches = self.serve_step(self.params, caches, tok, pos)
            tok = torch.argmax(logits, dim=-1)[:, None]
        return GenerationResult(torch.cat(out, dim=1), steps)
