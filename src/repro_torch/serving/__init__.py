"""Resilient multi-client serving over epoch snapshots (PyTorch port)."""
from repro_torch.serving.batch import BatchRunner
from repro_torch.serving.oracle import LogicalModel, NumpyTable
from repro_torch.serving.params import PARAM_QUERIES, ParamQuery
from repro_torch.serving.scheduler import (FAILED, OK, REJECTED, TIMED_OUT,
                                           QueryScheduler, Response,
                                           ServeConfig, Ticket)
from repro_torch.serving.workers import Worker, WorkerCrash, WorkerPool

__all__ = [
    "BatchRunner", "LogicalModel", "NumpyTable", "PARAM_QUERIES",
    "ParamQuery", "QueryScheduler", "Response", "ServeConfig", "Ticket",
    "Worker", "WorkerCrash", "WorkerPool",
    "OK", "REJECTED", "TIMED_OUT", "FAILED",
]
