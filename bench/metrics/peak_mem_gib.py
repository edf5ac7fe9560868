"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over set-up and
window, in GiB (2^30 bytes): tables, indexes, deltas, probe cache and
pinned copies, as the allocator counts them."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30
