"""JSPIM core (PyTorch port): hash dataset, dictionary, gathered probe."""
from repro_torch.core.dictionary import (DICT_PAD, NO_CODE, Dictionary,
                                         build_dictionary, decode, encode,
                                         encode_np)
from repro_torch.core.hash_table import (EMPTY_KEY, HASH_FIBONACCI,
                                         HASH_IDENTITY, JSPIMTable,
                                         build_table, hash_bucket,
                                         suggest_num_buckets, table_entries)
from repro_torch.core.lookup import (NULL_WORD, ProbeResult, pack_words,
                                     probe, unpack_words)
from repro_torch.core.policy import ExecutionPolicy

__all__ = ["DICT_PAD", "NO_CODE", "Dictionary", "build_dictionary", "decode",
           "encode", "encode_np", "EMPTY_KEY", "HASH_FIBONACCI",
           "HASH_IDENTITY", "JSPIMTable", "build_table", "hash_bucket",
           "suggest_num_buckets", "table_entries", "NULL_WORD",
           "ProbeResult", "pack_words", "probe", "unpack_words",
           "ExecutionPolicy"]
