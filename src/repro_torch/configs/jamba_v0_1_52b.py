"""Arch config: jamba-v0.1-52b (see registry.py for the definition)."""
from repro_torch.configs.registry import JAMBA as CONFIG

__all__ = ["CONFIG"]
