"""train_step: microbatched gradient accumulation + AdamW.

PyTorch port of ``repro.train.step``.  The batch arrives as
``(microbatches, per_step_batch, seq)``; a Python loop, where the reference
scans, runs each microbatch's forward and backward, so activation memory
is bounded by one microbatch (block remat inside the model bounds it
further to one repeat of the pattern).  Each parameter's gradient is added
to a float32 accumulator as soon as autograd has written it (a post-
accumulate hook) and then freed, so a microbatch's gradients are never all
held beside the accumulator.  The order of the reference's arithmetic is
kept: ``acc + g.float()`` per microbatch, then ``/ microbatches``, then
``apply_updates``; the loss is the mean over microbatches.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import ParamTree, init_params, loss_fn
from repro_torch.optim.adamw import (OptConfig, apply_updates,
                                     init_opt_state, tree_map, walk)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    accum_dtype: str = "float32"):
    """Returns train_step(params, opt_state, batch) -> (params', state',
    metrics); parameters and state are written in place."""
    acc_dt = getattr(torch, accum_dtype)

    def train_step(params: ParamTree, opt_state: dict,
                   batch: dict[str, Any]):
        tokens = batch["tokens"]           # (MB, per, S)
        labels = batch["labels"]
        image = batch.get("image_embeds")  # (MB, per, N, D) | None
        mb = tokens.shape[0]
        tree = params.tree()
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                               device=p.device), tree)

        def accumulate(p: torch.Tensor, acc: torch.Tensor) -> None:
            acc.add_(p.grad)
            p.grad = None

        hooks = []
        for p, acc in walk(tree, grads):
            p.grad = None
            hooks.append(p.register_post_accumulate_grad_hook(
                lambda p, acc=acc: accumulate(p, acc)))
        try:
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)
            for i in range(mb):
                im = image[i] if image is not None else None
                loss = loss_fn(cfg, params, tokens[i], labels[i], im)
                loss.backward()
                loss_sum = loss_sum + loss.detach()
        finally:
            for h in hooks:
                h.remove()
        for (g,) in walk(grads):
            g.div_(mb)
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg)
        metrics = dict(metrics, loss=loss_sum / mb)
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, opt_cfg: OptConfig, seed: int = 0,
                     device=None) -> tuple[ParamTree, dict]:
    """Parameters from ``seed`` and a fresh optimizer state, on the card
    unless ``device`` names another (``"meta"`` sizes them for free)."""
    params = init_params(cfg, seed, device)
    return params, init_opt_state(params, opt_cfg)
