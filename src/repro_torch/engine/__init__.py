"""Column-store engine (PyTorch port): SSB tables, joins, the 13 queries,
dimension ingest and compaction, the fact-side streaming append, the
skew-aware probe schedules, epoch snapshots."""
from repro_torch.engine.convert import (build_stats_from, dim_index_from_numpy,
                                        tables_from_numpy)
from repro_torch.engine.join import (BuildStats, DimIndex, build_dim_index,
                                     compact_index, effective_index,
                                     extend_cached_probe, ingest_index,
                                     join_pairs, lookup, lookup_filtered,
                                     tail_lookup)
from repro_torch.engine.queries import SSB_QUERIES, SSBEngine
from repro_torch.engine.snapshot import EpochSnapshot
from repro_torch.engine.ssb import (generate_fact_batch, generate_ssb,
                                    generate_ssb_dims, random_mutation)
from repro_torch.engine.table import Table, resolve_device

__all__ = ["build_stats_from", "dim_index_from_numpy", "tables_from_numpy",
           "BuildStats", "DimIndex", "build_dim_index", "compact_index",
           "effective_index", "extend_cached_probe", "ingest_index",
           "join_pairs", "lookup", "lookup_filtered", "tail_lookup",
           "SSB_QUERIES", "SSBEngine", "EpochSnapshot",
           "generate_fact_batch", "generate_ssb",
           "generate_ssb_dims", "random_mutation", "Table",
           "resolve_device"]
