"""Configurations: the paper's database deployment (``jspim_db``), the 10
assigned model architectures and their input shapes."""
from repro_torch.configs.jspim_db import SSB_PIM, TABLE3_PIM, TIMING
from repro_torch.configs.registry import get_config, list_archs, smoke
from repro_torch.configs.shapes import SHAPES, input_specs, shape_applicable

__all__ = ["SSB_PIM", "TABLE3_PIM", "TIMING", "get_config", "list_archs",
           "smoke", "SHAPES", "input_specs", "shape_applicable"]
