"""Arch config: qwen3-4b (see registry.py for the definition)."""
from repro_torch.configs.registry import QWEN3_4B as CONFIG

__all__ = ["CONFIG"]
