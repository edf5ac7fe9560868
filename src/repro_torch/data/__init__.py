"""The LM data pipeline (PyTorch port of ``repro.data``)."""
from repro_torch.data.pipeline import Prefetcher, ZipfTokenStream, shard_batch

__all__ = ["Prefetcher", "ZipfTokenStream", "shard_batch"]
