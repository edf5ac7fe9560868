"""Launchers (PyTorch port of ``repro.launch``): the shard mesh, the
elastic re-placement of fact columns and checkpoint leaves, the logical
sharding axes, and the serving and training CLIs (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``)."""
from repro_torch.launch.elastic import shard_fact_columns, shard_multiple
from repro_torch.launch.mesh import (Placement, ShardMesh, dp_size,
                                     make_data_mesh, make_host_mesh)
from repro_torch.launch.sharding import constrain, resolve

__all__ = ["shard_fact_columns", "shard_multiple", "Placement", "ShardMesh",
           "dp_size", "make_data_mesh", "make_host_mesh", "constrain", "resolve"]
