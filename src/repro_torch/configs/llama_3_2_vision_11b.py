"""Arch config: llama-3.2-vision-11b (see registry.py for the definition)."""
from repro_torch.configs.registry import LLAMA32_VISION as CONFIG

__all__ = ["CONFIG"]
