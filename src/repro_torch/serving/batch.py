"""Batched dispatch: many parameter vectors of one query in one pass.

PyTorch port of ``repro.serving.batch``.  The JAX package vmaps the shared
``_filter_aggregate`` tail over a ``(B, P)`` parameter array inside one
compiled program.  Here the tail is evaluated for the B requests as
batched tensors instead: the probes and everything else that does not
depend on the parameters (the join mask, the measure, the composite group
key) are computed once per dispatch; each dimension predicate becomes a
``(B, n_dim)`` mask (the parameters are ``(B, 1)`` columns, so the
``ParamQuery`` lambdas broadcast), is gathered to ``(B, rows)`` through the
probed rows, and the B segment sums run as one segment sum over ``B *
size`` segments.  Integer sums wrap the same way in any order, so every
request's answer is bit-identical to running its query alone.  (The JAX
package pads a batch to a power of two to bound its traces; eager torch
compiles nothing, so a batch here is evaluated at its own width.)

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
``batch.probes`` around the probes, ``batch.tail`` around each group's
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
from repro_torch.engine.queries import (FACT_FK, SSB_QUERIES, _clip_rows,
                                        _filter_aggregate)
from repro_torch.engine.table import Table
from repro_torch.kernels.ref import segment_sum
from repro_torch.serving.params import PARAM_QUERIES, ParamQuery

# Working-memory bound of the batched tail: requests x fact rows evaluated
# together.  A group of g requests over n rows holds about 11 g n bytes at
# once (a bool mask, int32 contributions and segment ids, the gathered
# dimension masks one at a time), so 2^28 cells is about 3 GB; at SF10
# (60M to 77M fact rows) that is 3 or 4 requests a group, and a wider
# batch runs group after group.
MAX_BATCH_CELLS = 1 << 28


def _batched_tail(pq: ParamQuery, fact_cols, dim_cols, probes,
                  params: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``_filter_aggregate`` of ``pq`` for every row of ``params`` (B, P):
    ``(totals (B,), groups (B, size))``, int32, each row bit-identical to
    the bound query run alone."""
    spec = SSB_QUERIES[pq.name]
    fact = Table(fact_cols)
    n, dev = fact.n_rows, fact.device
    b = params.shape[0]
    p = [params[:, j:j + 1] for j in range(params.shape[1])]
    base = torch.ones(n, dtype=torch.bool, device=dev)
    for dim in spec.joined_dims():
        base = base & probes[dim][0]
    mask = base.expand(b, n)
    for dim, f in pq.dim_filters.items():
        dmask = f(Table(dim_cols[dim]), p)
        dmask = dmask.expand(b, dmask.shape[-1])
        mask = mask & dmask[:, _clip_rows(probes[dim][1], dmask.shape[-1])]
    if pq.fact_filter is not None:
        mask = mask & pq.fact_filter(fact, p)
    contrib = torch.where(mask, spec.measure(fact).to(torch.int32), 0)
    totals = contrib.sum(dim=1).to(torch.int32)
    if not spec.group_by:
        return totals, totals[:, None]
    gk = torch.zeros(n, dtype=torch.int32, device=dev)
    size = 1
    for dim, col, card in spec.group_by:
        c = dim_cols[dim][col]
        gk = gk * card + torch.remainder(
            c[_clip_rows(probes[dim][1], c.shape[0])], card)
        size *= card
    # request i's segments are [i size, (i + 1) size); masked-out rows
    # contribute 0, which ``segment_sum`` drops
    ids = gk + torch.arange(b, dtype=torch.int32, device=dev)[:, None] * size
    groups = segment_sum(contrib.reshape(-1), ids.reshape(-1), b * size)
    return totals, groups.view(b, size)


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
        as a device fault would.  A batched dispatch evaluates at most
        ``MAX_BATCH_CELLS // rows`` requests at a time (at least one), so
        its working memory stays near ``11 * MAX_BATCH_CELLS`` bytes
        whatever the batch width.
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
        n = runner.tables["lineorder"].n_physical
        group = max(1, MAX_BATCH_CELLS // max(1, n))
        totals, groups = [], []
        for i in range(0, b, group):
            with trace.span("batch.tail", width=min(group, b - i)):
                t, g = _batched_tail(pq, fact_cols, dim_cols, probes,
                                     params[i:i + group])
            totals.append(t)
            groups.append(g)
        with trace.span("batch.readback", width=b):
            totals = torch.cat(totals).cpu().numpy()
            groups = torch.cat(groups).cpu().numpy()
        return [(int(totals[i]), groups[i]) for i in range(b)]
