"""Logical-axis sharding rules (FSDP over data/pod, TP/EP over model).

PyTorch port of ``repro.launch.sharding``, one-device part.  Logical axes:
  * "dp"  — batch/FSDP axis: resolves to ("pod", "data") when the mesh has a
            pod axis, else ("data",).
  * "tp"  — tensor/expert-parallel axis: resolves to "model".

``resolve`` is pure, on axis-name tuples.  ``constrain`` returns its input:
one device has no mesh, as the reference's is a no-op outside one.  The
parameter rules (``spec``, ``PARAM_RULES``, ``param_spec_for``,
``param_specs``, ``named_shardings``) come with the multi-process slice
(ROADMAP Queue 1 item 2d), as do the meshes of the training path:
``data.shard_batch``, ``train.Trainer`` and ``launch.train --mesh``
raise ``NotImplementedError`` when given one.
"""
from __future__ import annotations

from typing import Any

import torch


def resolve(logical: Any, mesh_axes: tuple[str, ...]) -> Any:
    """logical axis name(s) -> concrete mesh axis name(s) (or None)."""
    if logical is None:
        return None
    if isinstance(logical, (tuple, list)):
        out: list[str] = []
        for item in logical:
            r = resolve(item, mesh_axes)
            if r is None:
                continue
            out.extend(r if isinstance(r, tuple) else (r,))
        return tuple(out) if out else None
    if logical == "dp":
        axes = tuple(a for a in ("pod", "data") if a in mesh_axes)
        return axes if axes else None
    if logical == "tp":
        return "model" if "model" in mesh_axes else None
    # already a concrete axis name
    return logical if logical in mesh_axes else None


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The reference's sharding constraint; on one device, ``x`` itself."""
    return x
