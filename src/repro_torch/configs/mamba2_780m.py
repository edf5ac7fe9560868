"""Arch config: mamba2-780m (see registry.py for the definition)."""
from repro_torch.configs.registry import MAMBA2 as CONFIG

__all__ = ["CONFIG"]
