"""The paper's own deployment config (JSPIM on LRDIMM DDR4-3200).

PyTorch port's copy of ``repro.configs.jspim_db``.  SSB evaluation: 8
channels / 32 DIMMs (Table 1); PIM comparison (Table 3): 4 channels / 16
ranks, 32-bit keys and values.
"""
from repro_torch.core.costmodel import DDR4Timing, PIMConfig

SSB_PIM = PIMConfig(channels=8, ranks_per_channel=4)
TABLE3_PIM = PIMConfig(channels=4, ranks_per_channel=4)
TIMING = DDR4Timing()

__all__ = ["SSB_PIM", "TABLE3_PIM", "TIMING"]
