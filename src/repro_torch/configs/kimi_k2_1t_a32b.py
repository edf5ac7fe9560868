"""Arch config: kimi-k2-1t-a32b (see registry.py for the definition)."""
from repro_torch.configs.registry import KIMI_K2 as CONFIG

__all__ = ["CONFIG"]
