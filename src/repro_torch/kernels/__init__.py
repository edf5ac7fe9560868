"""Hand-written CUDA kernels for Hopper, their plain versions, the registry.

Kernel sources live in ``csrc/`` and are compiled with ``nvcc`` at the
first launch (``_build``); importing this package needs no CUDA toolkit.
"""
from repro_torch.kernels.batched_tail import (batched_tail,
                                              batched_tail_plain)
from repro_torch.kernels.bucket_probe import (
    bucket_probe_stream, bucket_probe_stream_plain,
    pack_bits, pack_bits_plain, probe_filter_rows,
    probe_filter_rows_delta, probe_filter_rows_delta_plain,
    probe_filter_rows_plain, probe_rows, probe_rows_plain)
from repro_torch.kernels.coalesce_window import (coalesce_window_mask,
                                                 coalesce_window_mask_plain)
from repro_torch.kernels.fused_query import fused_query, fused_query_plain
from repro_torch.kernels.ops import (KERNEL_REGISTRY, KernelOp,
                                     delta_slot_words, kernel_supported,
                                     probe_table, probe_table_filtered,
                                     probe_table_filtered_delta,
                                     probe_table_ref, register_kernel,
                                     slot_predicate)
from repro_torch.kernels.ref import (NULL_WORD, bucket_probe_ref,
                                     fused_query_ref,
                                     probe_filter_rows_delta_ref,
                                     probe_filter_rows_ref, probe_rows_ref,
                                     segment_sum, unpack_words)

__all__ = ["batched_tail", "batched_tail_plain",
           "bucket_probe_stream", "bucket_probe_stream_plain",
           "pack_bits", "pack_bits_plain",
           "probe_filter_rows", "probe_filter_rows_delta",
           "probe_filter_rows_delta_plain", "probe_filter_rows_plain",
           "probe_rows", "probe_rows_plain", "coalesce_window_mask",
           "coalesce_window_mask_plain", "fused_query",
           "fused_query_plain", "KERNEL_REGISTRY", "KernelOp",
           "delta_slot_words", "kernel_supported", "probe_table",
           "probe_table_filtered", "probe_table_filtered_delta",
           "probe_table_ref", "register_kernel", "slot_predicate",
           "NULL_WORD", "bucket_probe_ref", "fused_query_ref",
           "probe_filter_rows_delta_ref", "probe_filter_rows_ref",
           "probe_rows_ref", "segment_sum", "unpack_words"]
