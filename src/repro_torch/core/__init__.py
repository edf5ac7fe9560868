"""JSPIM core (PyTorch port): hash dataset, dictionary, probe schedules,
join/select, dedup, skew statistics, delta buffer, planning."""
from repro_torch.core.dedup import (Coalesced, coalesce, duplication_factor,
                                    scatter_back, windowed_coalesce_mask)
from repro_torch.core.delta import (TOMBSTONE, DeltaStats, DeltaTable,
                                    apply_batch, delete_batch, delta_entries,
                                    delta_is_empty, delta_lookup, delta_stats,
                                    empty_delta, insert_batch, merge_entries,
                                    suggest_delta_buckets, upsert_batch,
                                    weighted_entries)
from repro_torch.core.dictionary import (DICT_PAD, NO_CODE, Dictionary,
                                         build_dictionary, decode, encode,
                                         encode_np, extend_dictionary)
from repro_torch.core.hash_table import (EMPTY_KEY, HASH_FIBONACCI,
                                         HASH_IDENTITY, JSPIMTable,
                                         build_table, entry_update,
                                         hash_bucket, index_update,
                                         suggest_num_buckets, table_entries,
                                         table_update)
from repro_torch.core.lookup import (NULL_WORD, HotTable, JoinResult,
                                     ProbeResult, build_hot_table,
                                     hot_hit_count, join, overlay_delta,
                                     pack_words, probe, probe_deduped,
                                     probe_hot_cold, probe_with_delta,
                                     select_distinct, select_where_eq,
                                     splice_probe, unpack_words)
from repro_torch.core.planner import (BatchPlan, CompactionPlan,
                                      FactAppendPlan, QueryPlan,
                                      SchedulePlan, plan_batch,
                                      plan_compaction, plan_fact_append,
                                      plan_probe, plan_query, refine_plan,
                                      skew_drift)
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.core.skew import SkewStats, measure_skew, top_keys

__all__ = ["Coalesced", "coalesce", "duplication_factor", "scatter_back",
           "windowed_coalesce_mask", "TOMBSTONE", "DeltaStats", "DeltaTable",
           "apply_batch", "delete_batch", "delta_entries", "delta_is_empty",
           "delta_lookup", "delta_stats", "empty_delta", "insert_batch",
           "merge_entries", "suggest_delta_buckets", "upsert_batch",
           "weighted_entries",
           "DICT_PAD", "NO_CODE", "Dictionary", "build_dictionary", "decode",
           "encode", "encode_np", "extend_dictionary", "EMPTY_KEY",
           "HASH_FIBONACCI", "HASH_IDENTITY", "JSPIMTable", "build_table",
           "entry_update", "hash_bucket", "index_update",
           "suggest_num_buckets", "table_entries", "table_update",
           "NULL_WORD", "HotTable", "JoinResult", "ProbeResult",
           "build_hot_table", "hot_hit_count", "join", "overlay_delta",
           "pack_words", "probe", "probe_deduped", "probe_hot_cold",
           "probe_with_delta", "select_distinct", "select_where_eq",
           "splice_probe", "unpack_words", "BatchPlan", "CompactionPlan",
           "FactAppendPlan", "QueryPlan", "SchedulePlan", "plan_batch",
           "plan_compaction", "plan_fact_append", "plan_probe", "plan_query",
           "refine_plan", "skew_drift",
           "ExecutionPolicy", "resolve_policy", "SkewStats", "measure_skew",
           "top_keys"]
