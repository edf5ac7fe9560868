"""Arch config: qwen3-32b (see registry.py for the definition)."""
from repro_torch.configs.registry import QWEN3_32B as CONFIG

__all__ = ["CONFIG"]
