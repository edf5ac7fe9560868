"""Mixture-of-Experts with JSPIM-style binned dispatch.

PyTorch port of ``repro.models.moe``.  Token→expert routing is a skewed
join: expert ids are the keys, hot experts are hot keys.  Dispatch reuses
the JSPIM probe schedule — sort the assignment stream by expert ("bucket")
id, segment into fixed-capacity expert buffers ("bucket rows"), process
every bucket with dense batched matmuls, and scatter results back through
the inverse permutation (the duplication-list inverse).  Capacity overflow
= bucket overflow: dropped assignments fall back to the residual path.

The reference's ``.at[slot].set(..., mode="drop")`` is a write into one
spill row at ``E·cap`` that is sliced off.  Its combine,
``.at[token].add``, becomes a scatter back to ``(n, k)`` through the
inverse of the sort and a sum over ``k``: a fixed order, where
``index_add_`` on the card sums with atomics in no fixed order.

Under an active mesh with dp axes (``launch.sharding.activate``) the
grouped dispatch takes the reference's expert-sharded manual path,
``_grouped_manual``, whose per-``model`` expert buckets and partial sums
run region by region on the one device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.launch.sharding import constrain, get_mesh
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import activation, init_leaf


class MoEParams(NamedTuple):
    router: torch.Tensor          # (D, E) float32
    experts_w_in: torch.Tensor    # (E, D, F)
    experts_w_gate: torch.Tensor  # (E, D, F)
    experts_w_out: torch.Tensor   # (E, F, D)


def moe_shapes(cfg: ModelConfig) -> dict:
    """Each parameter's (shape, init, dtype or None for the model's), for
    ``layers.init_leaf``; the router is float32."""
    mc = cfg.moe
    e, d, f = mc.num_experts, cfg.d_model, mc.d_ff_expert
    return {"router": ((d, e), None, torch.float32),
            "experts_w_in": ((e, d, f), None, None),
            "experts_w_gate": ((e, d, f), None, None),
            "experts_w_out": ((e, f, d), None, None)}


def init_moe(cfg: ModelConfig, dtype: torch.dtype, *,
             generator: torch.Generator | None = None,
             device=None) -> MoEParams:
    return MoEParams(**{
        k: init_leaf(shape, init, dt or dtype, generator=generator,
                     device=device)
        for k, (shape, init, dt) in moe_shapes(cfg).items()})


def _capacity(n_tokens: int, mc: MoEConfig) -> int:
    c = int(n_tokens * mc.top_k * mc.capacity_factor / mc.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to sublane multiple


def _route(p: MoEParams, xf: torch.Tensor, k: int):
    """Top-k experts and their softmax gates per token (float32)."""
    logits = xf.float() @ p.router                       # (n, E)
    topv, topi = torch.topk(logits, k, dim=-1)           # (n, k)
    return topi, torch.softmax(topv, dim=-1)


class _Binned(NamedTuple):
    buf: torch.Tensor    # (E, cap, D) the expert buffers
    slot: torch.Tensor   # (n*k,) sorted assignment -> buffer row, E*cap drop
    keep: torch.Tensor   # (n*k,) within capacity
    sg: torch.Tensor     # (n*k,) gates in sorted order
    order: torch.Tensor  # (n*k,) the stable sort of the assignments


def _bin(xf: torch.Tensor, topi: torch.Tensor, gates: torch.Tensor,
         num_experts: int, cap: int) -> _Binned:
    """The binning pass: sort assignments by expert id (stable), position
    within each expert's run (left ``searchsorted``), fill the buffers."""
    n, k = topi.shape
    d = xf.shape[-1]
    dev = xf.device
    flat_e = topi.reshape(-1)                            # (n*k,) bucket ids
    flat_t = torch.arange(n, device=dev).repeat_interleave(k)
    se, order = torch.sort(flat_e, stable=True)
    st, sg = flat_t[order], gates.reshape(-1)[order]
    start = torch.searchsorted(se, torch.arange(num_experts, device=dev))
    pos = torch.arange(n * k, device=dev) - start[se]
    keep = pos < cap                                     # bucket overflow
    slot = torch.where(keep, se * cap + pos, num_experts * cap)
    buf = torch.zeros((num_experts * cap + 1, d), dtype=xf.dtype,
                      device=dev)
    buf[slot] = torch.where(keep[:, None], xf[st], 0)
    return _Binned(buf[:-1].reshape(num_experts, cap, d), slot, keep, sg,
                   order)


def _combine(out: torch.Tensor, bn: _Binned, n: int, k: int,
             dtype: torch.dtype) -> torch.Tensor:
    """Gather each assignment's expert output, weight it by its gate, put
    it back in token order and sum a token's ``k`` outputs (fixed order)."""
    num_experts, cap, d = out.shape
    vals = out.reshape(num_experts * cap, d)[
        torch.clamp(bn.slot, max=num_experts * cap - 1)]
    vals = torch.where(bn.keep[:, None], vals, 0) * bn.sg[:, None].to(dtype)
    unsorted = torch.empty_like(vals)
    unsorted[bn.order] = vals
    return unsorted.reshape(n, k, d).sum(dim=1)


def _experts(p: MoEParams, buf: torch.Tensor, act: str,
             spec: str) -> torch.Tensor:
    """Per-expert GLU FFN over the buffers (dense batched matmuls)."""
    h = torch.einsum(f"{spec}d,edf->{spec}f", buf, p.experts_w_in)
    g = activation(torch.einsum(f"{spec}d,edf->{spec}f", buf,
                                p.experts_w_gate), act)
    return torch.einsum(f"{spec}f,efd->{spec}d", h * g, p.experts_w_out)


def moe_ffn(p: MoEParams, cfg: ModelConfig, x: torch.Tensor,
            act: str = "swiglu") -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Fixed-shape binned dispatch.

    With ``cfg.moe_groups > 1`` the dispatch runs grouped: the token stream
    is split into G groups, each sorted, binned and combined on its own
    (the reference's one-device path of its grouped dispatch), with
    capacity enforced per group.
    """
    g = getattr(cfg, "moe_groups", 1)
    if g > 1:
        return _moe_ffn_grouped(p, cfg, x, act, g)
    mc = cfg.moe
    b, s, d = x.shape
    n = b * s
    k = mc.top_k
    xf = x.reshape(n, d)
    topi, gates = _route(p, xf, k)
    bn = _bin(xf, topi, gates, mc.num_experts, _capacity(n, mc))
    buf = constrain(bn.buf, "tp", None, None)            # EP all-to-all
    out = constrain(_experts(p, buf, act, "ec"), "tp", None, None)
    return _combine(out, bn, n, k, x.dtype).reshape(b, s, d)


def _moe_ffn_grouped(p: MoEParams, cfg: ModelConfig, x: torch.Tensor,
                     act: str, groups: int) -> torch.Tensor:
    """Grouped binned dispatch: the reference's ``vmap`` branch."""
    mc = cfg.moe
    b, s, d = x.shape
    n = b * s
    if n % groups:
        raise ValueError(f"{n} tokens do not split into {groups} groups")
    ng = n // groups
    k = mc.top_k
    xg = x.reshape(groups, ng, d)
    # the reference rounds the grouped capacity DOWN to a multiple of 8
    # (``-(-int(c)) // 8 * 8``), where ``_capacity`` rounds up
    cap = max(8, int(ng * k * mc.capacity_factor / mc.num_experts) // 8 * 8)
    dp = _dp_axes()
    mesh = get_mesh()
    has_model = bool(dp) and "model" in mesh.axis_names
    tp_size = mesh.shape["model"] if has_model else 1
    if dp and mc.num_experts % tp_size == 0:
        topi, gates = _route(p, xg, k)
        return _grouped_manual(p, cfg, x, act, groups, xg, gates, topi,
                               cap, ng, k, dp, tp_size)
    bins = [_bin(xg[i], *_route(p, xg[i], k), mc.num_experts, cap)
            for i in range(groups)]
    buf = torch.stack([bn.buf for bn in bins])           # (G, E, cap, D)
    out = _experts(p, buf, act, "gec")
    y = torch.stack([_combine(out[i], bn, ng, k, x.dtype)
                     for i, bn in enumerate(bins)])
    return y.reshape(b, s, d)


def _dp_axes() -> tuple[str, ...]:
    m = get_mesh()
    if m is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in m.axis_names)


class _Route(NamedTuple):
    """The grouped routing metadata, every tensor (G, ng*k) in each
    group's stable expert order."""
    se: torch.Tensor     # expert ids, sorted
    pos: torch.Tensor    # position within the expert's run
    st: torch.Tensor     # token of each sorted assignment
    order: torch.Tensor  # the stable sort of the group's assignments
    cap: int
    e_local: int
    tp_size: int
    k: int

    def local(self, m: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Model region ``m``'s slot rule (the reference's ``_local``):
        within its ``e_local`` experts and the capacity, a row of its
        ``(e_local * cap)`` buffer, else the drop row ``e_local * cap``."""
        e0 = m * self.e_local
        ok = ((self.se >= e0) & (self.se < e0 + self.e_local)
              & (self.pos < self.cap))
        lslot = torch.where(ok, (self.se - e0) * self.cap + self.pos,
                            self.e_local * self.cap)
        return ok, lslot

    def expert_rows(self, buf: torch.Tensor, m: int) -> torch.Tensor:
        """Region ``m``'s experts of a (G, E, cap, D) buffer as
        (G, e_local * cap, D)."""
        g, _, _, d = buf.shape
        e0 = m * self.e_local
        return buf[:, e0:e0 + self.e_local].reshape(g, -1, d)

    def gather_rows(self, rows: torch.Tensor, m: int) -> torch.Tensor:
        """Each sorted assignment's row of region ``m``'s buffer rows,
        zero where the assignment is not the region's."""
        ok, lslot = self.local(m)
        idx = torch.clamp(lslot, max=rows.shape[1] - 1)
        vals = torch.gather(rows, 1, idx[..., None].expand(
            -1, -1, rows.shape[-1]))
        return torch.where(ok[..., None], vals, 0)

    def scatter_rows(self, vals: torch.Tensor, m: int) -> torch.Tensor:
        """Region ``m``'s (G, e_local, cap, D) buckets of the sorted
        assignments ``vals`` (the reference's ``mode="drop"`` scatter:
        the rest lands in a drop row that is sliced off)."""
        ok, lslot = self.local(m)
        g, _, d = vals.shape
        buf = vals.new_zeros((g, self.e_local * self.cap + 1, d))
        gi = torch.arange(g, device=vals.device)[:, None]
        buf[gi, lslot] = torch.where(ok[..., None], vals, 0)
        return buf[:, :-1].reshape(g, self.e_local, self.cap, d)

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(G, ng, D) -> each sorted assignment's token row."""
        return torch.gather(x, 1, self.st[..., None].expand(
            -1, -1, x.shape[-1]))

    def to_tokens(self, vals: torch.Tensor) -> torch.Tensor:
        """Sorted assignments (G, ng*k, D) -> (G, ng, D): back through the
        inverse of the sort, a token's ``k`` rows summed (fixed order)."""
        g, nk, d = vals.shape
        unsorted = torch.empty_like(vals)
        gi = torch.arange(g, device=vals.device)[:, None]
        unsorted[gi, self.order] = vals
        return unsorted.reshape(g, nk // self.k, self.k, d).sum(dim=2)


def _sum_regions(parts):
    """The sum over ``model`` regions, in region order (the psum)."""
    out = None
    for part in parts:
        out = part if out is None else out + part
    return out


class _Dispatch(torch.autograd.Function):
    """Each model region fills the buckets of its own experts; the backward
    is the expert-local gather summed over ``model``."""

    @staticmethod
    def forward(ctx, xg: torch.Tensor, route: _Route) -> torch.Tensor:
        ctx.route = route
        rows = route.tokens(xg)
        return torch.cat([route.scatter_rows(rows, m)
                          for m in range(route.tp_size)], dim=1)

    @staticmethod
    def backward(ctx, dbuf: torch.Tensor):
        r = ctx.route
        return _sum_regions(
            r.to_tokens(r.gather_rows(r.expert_rows(dbuf, m), m))
            for m in range(r.tp_size)), None


class _Combine(torch.autograd.Function):
    """Each model region gathers its experts' outputs, weights them by
    their gates and sums a token's rows; the partials are summed over
    ``model``.  The backward scatters the gated cotangent into the
    buckets and gives each gate its cotangent, summed over ``model``."""

    @staticmethod
    def forward(ctx, out: torch.Tensor, sg: torch.Tensor,
                route: _Route) -> torch.Tensor:
        ctx.route = route
        ctx.save_for_backward(out, sg)
        gate = sg[..., None].to(out.dtype)
        return _sum_regions(
            route.to_tokens(route.gather_rows(route.expert_rows(out, m), m)
                            * gate)
            for m in range(route.tp_size))

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        r = ctx.route
        out, sg = ctx.saved_tensors
        dyt = r.tokens(dy)
        upd = dyt * sg[..., None].to(dy.dtype)
        dout = torch.cat([r.scatter_rows(upd, m) for m in range(r.tp_size)],
                         dim=1)
        dsg = _sum_regions(
            (r.gather_rows(r.expert_rows(out, m), m).float()
             * dyt.float()).sum(dim=-1)
            for m in range(r.tp_size))
        return dout.to(out.dtype), dsg, None


def _grouped_manual(p: MoEParams, cfg: ModelConfig, x: torch.Tensor,
                    act: str, groups: int, xg: torch.Tensor,
                    gates: torch.Tensor, topi: torch.Tensor, cap: int,
                    ng: int, k: int, dp: tuple[str, ...],
                    tp_size: int) -> torch.Tensor:
    """Expert-sharded manual dispatch: each (dp, model) region builds only
    ITS experts' buckets from its groups, so dispatch needs no exchange;
    combine sums the regions' partial outputs over ``model``, the only
    exchange besides the FSDP weight stream.  The groups are independent,
    so every dp region's groups go through one batched op per model
    region; the model regions run one after another.  Two
    ``autograd.Function``s keep the backward region-local, as the
    reference's ``custom_vjp``s do (the transpose of a bucket scatter is a
    bucket gather).  The assembled (G, E, cap, D) buffer equals the
    grouped path's."""
    mc = cfg.moe
    b, s, d = x.shape
    mesh = get_mesh()
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    if groups % n_dp:
        raise ValueError(f"{groups} MoE groups do not split over the "
                         f"{n_dp} dp regions of {dp}")
    dev = x.device
    # ---- routing metadata (integer sort per group) ----------------------
    flat_e = topi.reshape(groups, ng * k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    st = torch.arange(ng, device=dev).repeat_interleave(k)[order]
    start = torch.searchsorted(
        se, torch.arange(mc.num_experts, device=dev).expand(
            groups, -1).contiguous())
    pos = torch.arange(ng * k, device=dev) - torch.gather(start, 1, se)
    route = _Route(se, pos, st, order, cap, mc.num_experts // tp_size,
                   tp_size, k)
    # differentiable gate stream in the same sorted order
    sg = torch.gather(gates.reshape(groups, -1), 1, order)

    buf = constrain(_Dispatch.apply(xg, route), "dp", "tp", None, None)
    out = constrain(_experts(p, buf, act, "gec"), "dp", "tp", None, None)
    y = constrain(_Combine.apply(out, sg, route), "dp", None, None)
    return y.reshape(b, s, d)


def moe_ffn_dense_fallback(p: MoEParams, cfg: ModelConfig, x: torch.Tensor,
                           act: str = "swiglu") -> torch.Tensor:
    """Reference dispatch: dense one-hot masking (no binning).  O(n·E) —
    the oracle for the binned path."""
    mc = cfg.moe
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    topi, gates = _route(p, xf, mc.top_k)
    y = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    for e in range(mc.num_experts):
        w = ((topi == e) * gates).sum(dim=-1)            # (n,)
        h = xf @ p.experts_w_in[e]
        g = activation(xf @ p.experts_w_gate[e], act)
        o = (h * g) @ p.experts_w_out[e]
        y = y + w[:, None] * o.float()
    return y.to(x.dtype).reshape(b, s, d)


def routing_skew_stats(logits: torch.Tensor, top_k: int) -> dict:
    """Expert load imbalance (the skew JSPIM-style dispatch absorbs)."""
    topi = torch.topk(logits, top_k, dim=-1).indices
    counts = torch.bincount(topi.reshape(-1), minlength=logits.shape[-1])
    mean = counts.float().mean()
    return {"max_over_mean": counts.max() / torch.clamp(mean, min=1),
            "frac_empty": (counts == 0).float().mean()}
