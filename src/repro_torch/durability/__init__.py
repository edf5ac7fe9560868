"""Durability tier (PyTorch port): epoch-keyed WAL, checkpoints, crash
recovery, and the fault-point machinery the serving and durability
harnesses share.

DESIGN.md §10.  Entry points: ``SSBEngine.persist(root)`` to start
logging, ``SSBEngine.open(root)`` to recover (on the card unless the
caller passes ``device="cpu"``); the classes here are the machinery behind
them (and the crash-injection surface for tests).  The log and checkpoint
files are the JAX package's, byte for byte: a root written by either
package recovers in the other.
"""
from repro_torch.durability.faults import (NULL_FAULTS, CrashPoint,
                                           FaultRegistry, OpSchedule,
                                           SiteProxy, boom_on,
                                           checkpoint_crash_sites)
from repro_torch.durability.fsio import FailpointFS, OsFS
from repro_torch.durability.manager import (DurabilityManager, RecoveryError,
                                            apply_record, open_engine)
from repro_torch.durability.state import (build_engine_from_state,
                                          engine_state, state_nbytes)
from repro_torch.durability.wal import (KINDS, SEMANTIC_KINDS, WALError,
                                        WALRecord, WriteAheadLog,
                                        read_records, scan)

__all__ = ["CrashPoint", "FailpointFS", "OsFS", "FaultRegistry",
           "NULL_FAULTS", "OpSchedule", "SiteProxy", "boom_on",
           "checkpoint_crash_sites", "DurabilityManager",
           "RecoveryError", "apply_record", "open_engine",
           "build_engine_from_state", "engine_state", "state_nbytes",
           "KINDS", "SEMANTIC_KINDS", "WALError", "WALRecord",
           "WriteAheadLog", "read_records", "scan"]
