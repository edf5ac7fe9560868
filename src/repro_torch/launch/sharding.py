"""Logical-axis sharding rules (FSDP over data/pod, TP/EP over model).

PyTorch port of ``repro.launch.sharding``.  Logical axes:
  * "dp"  — batch/FSDP axis: resolves to ("pod", "data") when the mesh has a
            pod axis, else ("data",).
  * "tp"  — tensor/expert-parallel axis: resolves to "model".

A spec is a tuple with one entry per dimension: a mesh axis name, a tuple
of names, or ``None``; the counterpart of ``PartitionSpec``.  The active
mesh (``activate``, ``get_mesh``, ``mesh_axis_names``) stands in for the
reference's ``compat`` mesh context.  It is one per process, not per
thread: autograd runs a CUDA backward on threads of its own, and a remat
recompute there must see the mesh its forward saw.  ``constrain``
returns its input: on a one-device ``ShardMesh`` every region is a view
of one tensor, so a constraint changes no value, as the reference's
changes none.  ``named_shardings`` gives ``Placement``s, which
``place`` attaches to a tensor as its ``placement`` attribute (the
counterpart of ``jax.Array.sharding``).
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, Iterator

import torch

from repro_torch.launch.mesh import Placement, ShardMesh

_ACTIVE: list[ShardMesh] = []


@contextlib.contextmanager
def activate(mesh: ShardMesh) -> Iterator[ShardMesh]:
    """``with activate(mesh):`` makes ``mesh`` the active mesh (nested
    activations stack)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def get_mesh() -> ShardMesh | None:
    """The active mesh, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def mesh_axis_names() -> tuple[str, ...]:
    m = get_mesh()
    return tuple(m.axis_names) if m is not None else ()


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


def spec(*logical_axes) -> tuple:
    """A spec against the active mesh."""
    axes = mesh_axis_names()
    return tuple(resolve(a, axes) for a in logical_axes)


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The reference's sharding constraint: ``x`` itself."""
    return x


# ---------------------------------------------------------------------------
# Parameter sharding rules: path-regex -> logical axes per dim.
# Parameters inside scanned blocks carry a leading repeats dim (None).
# ---------------------------------------------------------------------------
PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings: vocab over dp (FSDP), d_model over tp
    (r"embed/tokens$",        ("dp", "tp")),
    (r"lm_head$",             (None, "tp")),          # (D, V) vocab-parallel
    # attention projections (R, D, H*hd) / (R, H*hd, D)
    (r"mixer/w[qkv]$",        (None, "dp", "tp")),
    (r"mixer/wo$",            (None, "tp", "dp")),
    (r"mixer/[qk]_norm$",     (None, None)),
    # dense FFN
    (r"ffn/w_(in|gate)$",     (None, "dp", "tp")),
    (r"ffn/w_out$",           (None, "tp", "dp")),
    # MoE: experts over tp (EP), d_model over dp (FSDP)
    (r"ffn/router$",          (None, "dp", None)),
    (r"ffn/experts_w_(in|gate)$", (None, "tp", "dp", None)),
    (r"ffn/experts_w_out$",   (None, "tp", None, "dp")),
    # Mamba2 SSD
    (r"mixer/in_proj$",       (None, "dp", "tp")),
    (r"mixer/out_proj$",      (None, "tp", "dp")),
    (r"mixer/conv_w$",        (None, None, "tp")),
    (r"mixer/(A_log|D_skip|dt_bias)$", (None, "tp")),
    (r"mixer/ssm_norm$",      (None, "tp")),
    # norm gains (stacked): replicated
    (r"ln[12]$",              (None, None)),
    (r"final_norm$",          (None,)),
]


def param_spec_for(path: str, ndim: int) -> tuple:
    """The sharding rule's spec for a parameter path ('a/b/c') against
    the active mesh."""
    axes = mesh_axis_names()
    for pat, logical in PARAM_RULES:
        if re.search(pat, path):
            lg = logical[-ndim:] if len(logical) >= ndim else (
                (None,) * (ndim - len(logical)) + tuple(logical))
            return tuple(resolve(a, axes) for a in lg)
    return ()  # replicate by default


def map_tree(fn: Callable, tree, *others, path: str = ""):
    """``fn(path, leaf, *others' leaves)`` over a dict/list tree (a
    ``ParamTree`` as its ``tree()``); a path joins dict keys and list
    indices with ``/``, as the reference's ``_path_str`` does.  Tuples
    are leaves (specs are tuples)."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.tree()
    others = tuple(o.tree() if isinstance(o, torch.nn.Module) else o
                   for o in others)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(o[k] for o in others),
                            path=f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(o[i] for o in others),
                         path=f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree, *others)


def param_specs(params) -> Any:
    """Spec tree matching a params tree or ``ParamTree`` (active mesh)."""
    return map_tree(lambda path, leaf: param_spec_for(path, leaf.dim()),
                    params)


def named_shardings(mesh: ShardMesh, tree_of_specs) -> Any:
    """``Placement(mesh, spec)`` per spec of the tree."""
    return map_tree(lambda _, s: Placement(mesh, tuple(s)), tree_of_specs)


def place(t: torch.Tensor, placement: Placement) -> torch.Tensor:
    """``t`` on ``placement.mesh.device`` (no copy when it is there
    already), carrying ``placement`` as its ``placement`` attribute."""
    out = t.to(placement.mesh.device)
    out.placement = placement
    return out
