"""Batched dispatch: many parameter vectors of one query in one pass.

PyTorch port of ``repro.serving.batch``.  The JAX package vmaps the shared
``_filter_aggregate`` tail over a ``(B, P)`` parameter array inside one
compiled program and XLA fuses it.  Here the tail is the hand-written
``batched_tail`` kernel (``kernels/batched_tail.py``; its plain version on
CPU tensors), one launch per 32 requests: the probes come once per
dispatch, each dimension predicate is evaluated by its ``ParamQuery``
lambda on the dimension table with ``(B, 1)`` parameter columns into a
word per dimension row (bit ``i`` request ``i``'s predicate), and the
kernel streams the fact rows once, keeping no mask, measure or group key
of their length in device memory.  Integer sums wrap the same way in any
order, so every request's answer is bit-identical to running its query
alone.  (The JAX package pads a batch to a power of two to bound its
traces; eager torch compiles nothing, so a batch here is evaluated at its
own width.)

Flavors:

* ``"batch"`` -- the probes from the runner's probe cache (``probe_dim``;
  on a snapshot that is the frozen cache or one lazy ``probe_rows`` launch
  per dimension), then the batched tail.
* ``"mega"`` -- the probes folded into the dispatch: one ``lookup`` per
  joined dimension (``probe_rows`` on the card, delta overlay included),
  then the batched tail.  Needs no probe cache.
* ``"composed"`` -- one request at a time through ``_filter_aggregate`` of
  the bound query: the degraded flavor the circuit breaker falls back to,
  deliberately not the batched code, so a fault in the batched path is
  never re-entered by its own fallback.

Spans (``repro_torch.trace``, off unless a run enables the recorder):
``batch.probes`` around the probes, ``batch.tail`` around the dispatch's
tail (each request's ``_filter_aggregate`` on the composed flavor) and
``batch.readback`` around the copies of the answers to the host.

All flavors read only the ``_QueryRunner`` surface (``probe_dim`` /
``tables`` / ``indexes``), so an ``EpochSnapshot`` serves batches exactly
as the engine would.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.durability.faults import NULL_FAULTS
from repro_torch.engine.join import effective_index, found_rows, lookup
from repro_torch.engine.queries import (FACT_FK, SSB_QUERIES,
                                        _filter_aggregate)
from repro_torch.kernels.batched_tail import (MAX_REQUESTS, batched_tail,
                                             tail_operands)
from repro_torch.serving.params import PARAM_QUERIES, ParamQuery


def _batched_tail(pq: ParamQuery, fact_cols, dim_cols, probes,
                  params: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``_filter_aggregate`` of ``pq`` for every row of ``params`` (B, P):
    ``(totals (B,), groups (B, size))``, int32, each row bit-identical to
    the bound query run alone.  One ``batched_tail`` (the kernel on CUDA
    tensors, its plain version on CPU tensors) per ``MAX_REQUESTS`` rows
    of ``params``, over operands built from ``pq``'s callables bound to
    their columns."""
    totals, groups = [], []
    for i in range(0, params.shape[0], MAX_REQUESTS):
        part = params[i:i + MAX_REQUESTS]
        spec = pq.bind([part[:, j:j + 1] for j in range(part.shape[1])])
        dim_ops, fact_word, measure, size = tail_operands(
            spec, fact_cols, dim_cols, probes, part.shape[0])
        t, g = batched_tail(dim_ops, fact_word, measure,
                            n_requests=part.shape[0], num_segments=size)
        totals.append(t)
        groups.append(g)
    if len(totals) == 1:
        return totals[0], groups[0]
    return torch.cat(totals), torch.cat(groups)


class BatchRunner:
    """Serves parameterized requests over a ``_QueryRunner``'s state.

    ``policy`` (the engine's ``ExecutionPolicy``) picks the default
    flavor: ``fusion="mega"`` makes it ``"mega"`` on a jspim runner, else
    ``"batch"``.  The runner keeps no state between dispatches, so a
    refreshed snapshot is served with nothing to rebuild.
    """

    def __init__(self, policy: ExecutionPolicy | None = None):
        self.policy = policy

    @staticmethod
    def _cols(runner, name: str):
        spec = SSB_QUERIES[name]
        fact_cols = dict(runner.tables["lineorder"].columns)
        dim_cols = {d: dict(runner.tables[d].columns)
                    for d in spec.joined_dims()}
        return fact_cols, dim_cols

    @staticmethod
    def _probes(runner, name: str, fact_cols, mega: bool):
        dims = SSB_QUERIES[name].joined_dims()
        if not mega:
            return {d: runner.probe_dim(d) for d in dims}
        return {d: found_rows(lookup(effective_index(runner.indexes[d]),
                                     fact_cols[FACT_FK[d]],
                                     impl=runner.probe_impl))
                for d in dims}

    def _resolve_flavor(self, runner, flavor: str | None,
                        composed: bool) -> str:
        if flavor is None:
            if composed:
                return "composed"
            if (self.policy is not None and self.policy.fusion == "mega"
                    and getattr(runner, "mode", None) == "jspim"):
                return "mega"
            return "batch"
        if flavor not in ("mega", "batch", "composed"):
            raise ValueError(f"unknown serve flavor {flavor!r}")
        if flavor == "mega" and getattr(runner, "mode", None) != "jspim":
            return "batch"     # no indexes to fold the probe over
        return flavor

    def run_batch(self, runner, name: str, params_list, *,
                  composed: bool = False, flavor: str | None = None,
                  faults=NULL_FAULTS) -> list[tuple[int, np.ndarray]]:
        """Serve ``params_list`` against ``runner``: one ``(total,
        groups)`` per request, on the host (int, numpy int32).

        ``flavor``: "mega", "batch" or "composed" (see the module
        docstring); ``composed=True`` is the legacy spelling of
        ``flavor="composed"``; with neither the policy decides.  ``faults``
        sees ``kernel_mega:{name}`` / ``kernel_batch:{name}`` once per
        dispatch and ``kernel_composed:{name}`` once per request, before
        anything of it launches: an injected crash fails the whole batch,
        as a device fault would.
        """
        if not params_list:
            return []
        pq = PARAM_QUERIES[name]
        for p in params_list:
            if len(p) != pq.n_params:
                raise ValueError(
                    f"{name} takes {pq.n_params} params {pq.params}, "
                    f"got {len(p)}: {tuple(p)!r}")
        flavor = self._resolve_flavor(runner, flavor, composed)
        if flavor == "composed":
            out = []
            operands = None
            for p in params_list:
                faults.hit(f"kernel_composed:{name}")
                if operands is None:
                    fact_cols, dim_cols = self._cols(runner, name)
                    with trace.span("batch.probes", flavor=flavor):
                        probes = self._probes(runner, name, fact_cols, False)
                    operands = (fact_cols, dim_cols, probes)
                with trace.span("batch.tail", width=1):
                    total, groups = _filter_aggregate(
                        pq.bind(tuple(int(x) for x in p)), *operands)
                with trace.span("batch.readback", width=1):
                    out.append((int(total), groups.cpu().numpy()))
            return out
        faults.hit(f"kernel_{flavor}:{name}")
        fact_cols, dim_cols = self._cols(runner, name)
        with trace.span("batch.probes", flavor=flavor):
            probes = self._probes(runner, name, fact_cols, flavor == "mega")
        b = len(params_list)
        params = torch.as_tensor(np.asarray(params_list, np.int32),
                                 device=runner.tables["lineorder"].device)
        with trace.span("batch.tail", width=b):
            totals, groups = _batched_tail(pq, fact_cols, dim_cols, probes,
                                           params)
        with trace.span("batch.readback", width=b):
            totals = totals.cpu().numpy()
            groups = groups.cpu().numpy()
        return [(int(totals[i]), groups[i]) for i in range(b)]
