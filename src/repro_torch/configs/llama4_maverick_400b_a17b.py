"""Arch config: llama4-maverick-400b-a17b (see registry.py for the definition)."""
from repro_torch.configs.registry import LLAMA4 as CONFIG

__all__ = ["CONFIG"]
