"""Configurations: the paper's database deployment (``jspim_db``)."""
from repro_torch.configs.jspim_db import SSB_PIM, TABLE3_PIM, TIMING

__all__ = ["SSB_PIM", "TABLE3_PIM", "TIMING"]
