"""LM serving (PyTorch port of ``repro.serve``): the greedy batch server
and its JSPIM page table."""
from repro_torch.serve.engine import GenerationResult, Server, make_serve_step
from repro_torch.serve.paged_kv import PageTable

__all__ = ["GenerationResult", "Server", "make_serve_step", "PageTable"]
