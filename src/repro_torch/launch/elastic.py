"""Elastic placement: fact columns, parameters and optimizer state onto
a mesh.

PyTorch port of ``repro.launch.elastic``.  A spec is a tuple with one
mesh axis name (or a tuple of names, or ``None``) per dimension, the
counterpart of ``PartitionSpec``.  A fact column sharded along an axis of
``n`` is one tensor of ``n`` equal regions (``launch/mesh.py``), so
placing it is padding it to the region layout: it is never silently
replicated.  ``reshard_params`` re-derives every parameter's
``Placement`` on a new mesh from the sharding rules, the restart path
after a mesh shrinks or grows; values are unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import Placement, ShardMesh
from repro_torch.launch.sharding import activate, map_tree, param_specs, place


def _axes_size(mesh: ShardMesh, axes) -> int:
    if axes is None:
        return 1
    axes = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _sanitize(spec, shape, mesh: ShardMesh, *,
              on_indivisible: str = "replicate") -> tuple:
    """Clamp a sharding spec to what ``shape`` can carry on ``mesh``.

    ``on_indivisible="replicate"`` (checkpoint leaves, weights): a
    dimension that is not a multiple of its axis size drops the axis and
    replicates, because the leaf must keep its exact logical shape.
    ``on_indivisible="error"``: raise instead, for callers (fact columns)
    for which losing the shard axis is the bug: they pad to the shard
    multiple first (``shard_multiple`` / ``shard_fact_columns``).
    """
    spec = tuple(spec or ())
    entries = spec + (None,) * (len(shape) - len(spec))
    out = []
    for d, a in zip(shape, entries):
        if a is not None and d % _axes_size(mesh, a):
            if on_indivisible == "error":
                raise ValueError(
                    f"dimension of {d} rows is not divisible by axis "
                    f"{a!r} (size {_axes_size(mesh, a)}); pad to the "
                    f"shard multiple instead of dropping the axis")
            a = None
        out.append(a)
    return tuple(out)


def shard_multiple(n: int, ndev: int) -> int:
    """Rows after padding ``n`` up to a multiple of ``ndev`` (>= 0)."""
    return -(-int(n) // int(ndev)) * int(ndev)


def shard_fact_columns(cols, mesh: ShardMesh, *, axis: str = "data",
                       fills, cap_per_shard: int | None = None):
    """Lay 1-D fact columns out as ``ndev`` regions along ``axis``, padded
    (never axis-dropped) when the length is not a shard multiple.

    Each column (a tensor or a host array) splits into ``ndev``
    contiguous per-shard slices of ``per = ceil(n / ndev)`` rows, the last
    one filled up with ``fills[name]``, each slice at the start of a
    region of ``cap_per_shard`` rows (default ``per``) whose rest holds
    the fill too (``EMPTY_KEY`` for FK columns, so padding never joins).
    Returns ``(device_cols, cap_per_shard, valid_per_shard)``: one
    ``(ndev * cap,)`` int32 tensor per column on ``mesh.device``, and the
    written rows per shard (live plus dead fill).
    """
    ndev = int(mesh.shape[axis])
    lens = {k: int(v.shape[0]) for k, v in cols.items()}
    if len(set(lens.values())) > 1:
        raise ValueError(f"ragged columns: {lens}")
    n = next(iter(lens.values())) if lens else 0
    per = shard_multiple(n, ndev) // ndev
    cap = per if cap_per_shard is None else int(cap_per_shard)
    if cap < per:
        raise ValueError(f"cap_per_shard {cap} below shard rows {per}")
    out = {}
    for k, v in cols.items():
        src = (v if torch.is_tensor(v)
               else torch.from_numpy(np.require(v, np.int32, "W")))
        src = src.to(device=mesh.device, dtype=torch.int32)
        fill = int(fills[k])
        buf = torch.full((ndev, cap), fill, dtype=torch.int32,
                         device=mesh.device)
        if per:
            flat = torch.full((ndev * per,), fill, dtype=torch.int32,
                              device=mesh.device)
            flat[:n] = src
            buf[:, :per] = flat.view(ndev, per)
        out[k] = buf.view(-1)
    return out, cap, per


def _alias(t: torch.Tensor, placement: Placement) -> torch.Tensor:
    """A new tensor object over ``t``'s storage (a copy only when the
    mesh lives on another device) carrying ``placement``; ``t`` keeps its
    own placement."""
    return place(t.detach(), placement)


def reshard_params(params, new_mesh: ShardMesh):
    """Place a (restored) params tree or ``ParamTree`` onto a new mesh
    per the rules, sanitized with ``on_indivisible="replicate"``.  Returns
    the same kind of tree; each leaf shares its storage with the input's
    on the same device and carries its ``Placement`` on ``new_mesh``."""
    from repro_torch.models.transformer import ParamTree

    with activate(new_mesh):
        places = map_tree(lambda _, leaf, s: Placement(
            new_mesh, _sanitize(s, leaf.shape, new_mesh)),
            params, param_specs(params))
    out = map_tree(lambda _, leaf, pl: _alias(leaf, pl), params, places)
    if isinstance(params, torch.nn.Module):
        out = ParamTree(out)    # new Parameter objects over the same storage
        map_tree(lambda _, leaf, pl: setattr(leaf, "placement", pl), out,
                 places)
    return out


def reshard_opt_state(opt_state: dict, params_resharded) -> dict:
    """Moments mirror the parameter placements (float32 moments); int8
    ``{q, s}`` moments and ``step`` are left as they are, as the reference
    leaves them."""
    out = dict(opt_state)
    for k in ("m", "v", "err"):
        if k in out and not _has_quantized(out[k]):
            out[k] = map_tree(lambda _, leaf, p: _alias(leaf, p.placement),
                              out[k], params_resharded)
    return out


def _has_quantized(tree) -> bool:
    if isinstance(tree, dict):
        return "q" in tree or any(_has_quantized(v) for v in tree.values())
    if isinstance(tree, list):
        return any(_has_quantized(v) for v in tree)
    return False
