"""Durability tier (PyTorch port): so far only the fault-point registry
the serving tier and its harnesses use (``faults.py``); the write-ahead
log, checkpoints and recovery arrive with the durability slice."""
from repro_torch.durability.faults import (NULL_FAULTS, CrashPoint,
                                           FaultRegistry, boom_on)

__all__ = ["NULL_FAULTS", "CrashPoint", "FaultRegistry", "boom_on"]
