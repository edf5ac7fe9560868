"""Launchers (PyTorch port of ``repro.launch``): the shard mesh and the
elastic re-placement of fact columns and checkpoint leaves."""
from repro_torch.launch.elastic import shard_fact_columns, shard_multiple
from repro_torch.launch.mesh import (Placement, ShardMesh, dp_size,
                                     make_data_mesh, make_host_mesh)

__all__ = ["shard_fact_columns", "shard_multiple", "Placement", "ShardMesh",
           "dp_size", "make_data_mesh", "make_host_mesh"]
