"""Incremental view maintenance over Z-sets (host numpy).

Keeps all 13 SSB answers current per mutation batch by subscribing to the
engine's mutation hooks: fact appends push weighted contributions through
the linear filter -> aggregate tail, and dimension mutations use the join
chain rule (maintained probe rows and postings) to retract and re-add
exactly the affected fact rows.
"""
from repro_torch.ivm.maintain import MaintainedSuite
from repro_torch.ivm.views import QueryView
from repro_torch.ivm.zset import ZSetAggregate, wrap_i32

__all__ = ["MaintainedSuite", "QueryView", "ZSetAggregate", "wrap_i32"]
