"""Shard meshes on one device.

PyTorch port of ``repro.launch.mesh``.  A JAX array sharded ``P(axis)``
over ``n`` devices is, seen whole, a column of ``n`` equal regions, shard
``r`` being region ``r``.  The port keeps that image on ONE device: a
:class:`ShardMesh` names the axes and their sizes and the device every
region lives on, and a sharded column is one tensor whose
``view(n, -1)[r]`` is shard ``r``.  The sharded engine
(``engine/shard.py``) works region by region, so its physical layout is
the reference's bit for bit.  Placing the regions on several cards waits
for a machine with more than one.  ``make_production_mesh`` builds the
dry-run's 256- and 512-chip meshes, on ``meta`` by default: nothing is
allocated on them.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A frozen, hashable mesh: axis sizes, axis names, and the device
    that holds every region.  ``shape`` maps each axis name to its size,
    as ``jax.sharding.Mesh.shape`` does."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.sizes} do not match axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate mesh axes {self.axis_names}")
        if any(int(n) < 1 for n in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a checkpoint leaf lands (``checkpoint.restore(shardings=)``):
    ``spec`` names a mesh axis (or ``None``) per dimension, the
    counterpart of ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    mesh: ShardMesh
    spec: tuple = ()


def _mesh(shape, axes, device) -> ShardMesh:
    # imported here: the engine imports this module
    from repro_torch.engine.table import resolve_device

    return ShardMesh(tuple(int(n) for n in shape), tuple(axes),
                     resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> ShardMesh:
    """Single pod: 16x16 = 256 chips (data, model).
    Multi-pod: 2x16x16 = 512 chips (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(shape=(2, 2), axes=("data", "model"),
                   device=None) -> ShardMesh:
    """A small mesh of ``shape`` over ``axes`` on ``device`` (default: the
    card)."""
    return _mesh(shape, axes, device)


def make_data_mesh(ndev: int = 1, axis: str = "data",
                   device=None) -> ShardMesh:
    """1-D mesh of ``ndev`` shard regions along ``axis`` on ``device``
    (default: the card, through ``resolve_device``).

    The axis the sharded fact engine runs on: dimension indexes are
    shared, the fact table splits into ``ndev`` regions.  ``ndev < 1``
    raises ``ValueError``, as in the reference.  The reference's upper
    bound, its device count, has no counterpart here: every region lives
    on the one device.
    """
    n = int(ndev)
    if n < 1:
        raise ValueError(f"ndev={n} must be at least 1")
    return _mesh((n,), (axis,), device)


def dp_size(mesh: ShardMesh) -> int:
    """The data-parallel size: the product of the ``pod`` and ``data``
    axes present in ``mesh``."""
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n
