"""JSPIM core (PyTorch port): hash dataset, dictionary, probes, delta
buffer, compaction planning."""
from repro_torch.core.delta import (TOMBSTONE, DeltaStats, DeltaTable,
                                    apply_batch, delete_batch, delta_entries,
                                    delta_is_empty, delta_lookup, delta_stats,
                                    empty_delta, insert_batch, merge_entries,
                                    suggest_delta_buckets, upsert_batch)
from repro_torch.core.dictionary import (DICT_PAD, NO_CODE, Dictionary,
                                         build_dictionary, decode, encode,
                                         encode_np, extend_dictionary)
from repro_torch.core.hash_table import (EMPTY_KEY, HASH_FIBONACCI,
                                         HASH_IDENTITY, JSPIMTable,
                                         build_table, entry_update,
                                         hash_bucket, index_update,
                                         suggest_num_buckets, table_entries,
                                         table_update)
from repro_torch.core.lookup import (NULL_WORD, ProbeResult, overlay_delta,
                                     pack_words, probe, probe_with_delta,
                                     unpack_words)
from repro_torch.core.planner import CompactionPlan, plan_compaction
from repro_torch.core.policy import ExecutionPolicy

__all__ = ["TOMBSTONE", "DeltaStats", "DeltaTable", "apply_batch",
           "delete_batch", "delta_entries", "delta_is_empty", "delta_lookup",
           "delta_stats", "empty_delta", "insert_batch", "merge_entries",
           "suggest_delta_buckets", "upsert_batch", "DICT_PAD", "NO_CODE",
           "Dictionary", "build_dictionary", "decode", "encode", "encode_np",
           "extend_dictionary", "EMPTY_KEY", "HASH_FIBONACCI",
           "HASH_IDENTITY", "JSPIMTable", "build_table", "entry_update",
           "hash_bucket", "index_update", "suggest_num_buckets",
           "table_entries", "table_update", "NULL_WORD", "ProbeResult",
           "overlay_delta", "pack_words", "probe", "probe_with_delta",
           "unpack_words", "CompactionPlan", "plan_compaction",
           "ExecutionPolicy"]
