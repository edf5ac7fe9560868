"""Arch config: musicgen-large (see registry.py for the definition)."""
from repro_torch.configs.registry import MUSICGEN as CONFIG

__all__ = ["CONFIG"]
