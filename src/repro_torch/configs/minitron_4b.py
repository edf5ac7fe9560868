"""Arch config: minitron-4b (see registry.py for the definition)."""
from repro_torch.configs.registry import MINITRON as CONFIG

__all__ = ["CONFIG"]
