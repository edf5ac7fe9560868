"""Launchers (PyTorch port of ``repro.launch``): the shard mesh, the
elastic re-placement of fact columns, parameters and optimizer state,
the logical sharding axes and parameter rules, the dry-run and its
roofline (``python -m repro_torch.launch.dryrun``), and the serving and
training CLIs (``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train``)."""
from repro_torch.launch.elastic import shard_fact_columns, shard_multiple
from repro_torch.launch.mesh import (Placement, ShardMesh, dp_size,
                                     make_data_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.sharding import (activate, constrain, get_mesh,
                                         param_spec_for, param_specs,
                                         resolve, spec)

__all__ = ["shard_fact_columns", "shard_multiple", "Placement", "ShardMesh",
           "dp_size", "make_data_mesh", "make_host_mesh",
           "make_production_mesh", "activate", "constrain", "get_mesh",
           "param_spec_for", "param_specs", "resolve", "spec"]
