"""Carry the JAX package's parameter tree into the port.

``params_from_reference(tree, cfg, device)`` takes the reference's
parameters as numpy arrays (``jax.tree.map(np.asarray, params)``: dicts and
lists of arrays) and returns the port's :class:`ParamTree` with the same
values, name for name, so that both packages compute on the same weights.
A ``bfloat16`` array (numpy's extension dtype, named ``"bfloat16"``) is read
through its 16-bit pattern, so nothing here imports ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.table import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import ParamTree, init_params


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """A numpy array (``bfloat16`` included) as a tensor on ``device``, bit
    for bit."""
    arr = np.array(arr)     # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def params_from_reference(tree: dict, cfg: ModelConfig,
                          device=None) -> ParamTree:
    """The reference tree as the port's parameters, on the card unless
    ``device`` names another.  Raises ``ValueError`` unless every name,
    shape and dtype equals what ``init_params(cfg)`` builds."""
    dev = resolve_device(device)
    params = ParamTree(_convert(tree, dev))
    want = {n: (tuple(p.shape), p.dtype)
            for n, p in init_params(cfg, device="meta").named_parameters()}
    got = {n: (tuple(p.shape), p.dtype) for n, p in params.named_parameters()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"the reference tree does not fit {cfg.name}: "
                         f"{diff[:6]}")
    return params
