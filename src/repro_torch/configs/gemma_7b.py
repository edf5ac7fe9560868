"""Arch config: gemma-7b (see registry.py for the definition)."""
from repro_torch.configs.registry import GEMMA as CONFIG

__all__ = ["CONFIG"]
