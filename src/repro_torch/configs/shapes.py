"""Assigned input shapes (4 per architecture) and ``meta`` tensor specs.

PyTorch port of ``repro.configs.shapes``.  ``input_specs`` returns tensors
on ``torch.device("meta")`` (shape and dtype, no storage) where the
reference returns ``jax.ShapeDtypeStruct``s.  ``long_500k`` applies only to
architectures with a sub-quadratic (state-based) path — mamba2 / jamba.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    microbatches: int = 1   # train: gradient-accumulation steps


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256, microbatches=16),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    if shape == "long_500k" and not cfg.has_subquadratic_path:
        return False, ("pure full-attention arch: 500k-token decode needs a "
                       "sub-quadratic path (SSM/hybrid only); skipped per "
                       "DESIGN.md §Arch-applicability")
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    sp = SHAPES[shape]
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)
    if sp.kind == "train":
        # microbatched: leading axis stepped by the train step
        mb = sp.microbatches
        per = sp.global_batch // mb
        specs = {
            "tokens": _spec((mb, per, sp.seq_len), i32),
            "labels": _spec((mb, per, sp.seq_len), i32),
        }
        if cfg.n_image_tokens:
            specs["image_embeds"] = _spec(
                (mb, per, cfg.n_image_tokens, cfg.d_model), dt)
        return specs
    if sp.kind == "prefill":
        specs = {"tokens": _spec((sp.global_batch, sp.seq_len), i32)}
        if cfg.n_image_tokens:
            specs["image_embeds"] = _spec(
                (sp.global_batch, cfg.n_image_tokens, cfg.d_model), dt)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {
        "token": _spec((sp.global_batch, 1), i32),
        "pos": _spec((), i32),
    }
