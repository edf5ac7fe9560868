"""Roofline terms of a dry-run cell on NVIDIA H100 SXM chips.

PyTorch port of ``repro.launch.roofline``.  Hardware model, NVIDIA H100
SXM data sheet (dense rates, no sparsity, at the 700 W limit):
    989 TFLOP/s bf16 per chip · 3.35 TB/s HBM3 · 80 GB HBM3 ·
    NVLink 4: 900 GB/s per chip, both directions of its 18 links summed.

``LINK_BW`` is that aggregate's one direction, 450 GB/s.  The reference
divided by ONE link because its torus ring runs each collective over one
link; on an NVSwitch system a chip's collective traffic is spread over
all 18 links at once, so its injection rate is the aggregate.  A mesh
past one 8-chip NVLink domain crosses the hosts' network, which is
slower and is not modeled: the collective term is a lower bound there.

``model_flops_for``, ``analytic_cost``, ``RooflineTerms`` and
``derive_terms`` are the reference's, unchanged.  The reference parses
its collective bytes out of XLA's partitioned HLO, which the port never
produces; ``collective_bytes`` reckons them from the shardings instead.
"""
from __future__ import annotations

import dataclasses
import math

PEAK_FLOPS = 989e12      # dense bf16 per chip (H100 SXM data sheet)
HBM_BW = 3.35e12         # bytes/s per chip, HBM3 (H100 SXM data sheet)
LINK_BW = 450e9          # bytes/s per chip one way, NVLink 4 aggregate
                         # (data sheet: 900 GB/s both ways)
HBM_CAP_H100 = 80e9      # bytes of HBM3 (H100 SXM data sheet: 80 GB)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _split(spec, mesh) -> tuple[int, int]:
    """(dp ways, other ways) a spec shards a leaf over."""
    dp = other = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (() if e is None else (e,))):
            if a in ("pod", "data"):
                dp *= mesh.shape[a]
            else:
                other *= mesh.shape[a]
    return dp, other


def _tp_reduced(path: str, spec) -> bool:
    """Whether a block's output leaves this weight summed over "model":
    an output projection sharded on its contracting dim, or the experts
    of an MoE FFN (its combine sums the model regions' partials)."""
    def has_model(e):
        return e == "model" or (isinstance(e, tuple) and "model" in e)
    if path.endswith(("mixer/wo", "mixer/out_proj", "ffn/w_out")):
        return len(spec) >= 2 and has_model(spec[-2])
    if path.endswith("ffn/experts_w_out"):
        return len(spec) >= 3 and has_model(spec[-3])
    return False


def collective_bytes(cfg, kind: str, mesh, leaves, global_batch: int,
                     seq_len: int, microbatches: int = 1) -> dict:
    """Per-collective-kind bytes (per chip, per step), reckoned from the
    shardings.

    ``leaves`` is ``[(path, shape, bytes per element, spec)]`` per
    parameter, ``spec`` sanitized for ``mesh``.  Bytes are each
    collective's result per chip, what the reference's HLO parse counts.
    With ``dp`` the ways a leaf is sharded over pod/data, ``tp`` the
    other ways, ``P`` its bytes, ``M`` the microbatches (1 when not
    training) and ``F`` the forward passes per microbatch (2 under
    ``remat="block"`` in training, the forward and its recompute, else 1):

      all-gather      sum over dp-sharded leaves of (P / tp) x M x (F + 1)
                      (training; F alone when not): one per forward pass
                      and one for the backward
      reduce-scatter  sum over dp-sharded leaves of P / (dp x tp) x M
                      (training): each microbatch's gradient
      all-reduce      sum over dp-replicated leaves of P / tp x M
                      (training, a dp mesh), and per layer whose mixer or
                      FFN output is summed over "model" (``_tp_reduced``):
                      one ``(b, s, D)`` activation in ``cfg.dtype`` per
                      forward pass and one for the backward's input
                      gradient, ``b`` the batch rows per dp shard (all of
                      them where dp does not divide them), ``s`` the
                      sequence (1 in decode)
      all-to-all, collective-permute   0 (the manual MoE dispatch
                      exchanges nothing; the SP knob is not modeled)
    """
    train = kind == "train"
    m = microbatches if train else 1
    fwd = 2 if train and cfg.remat == "block" else 1
    gathers = fwd + 1 if train else fwd
    n_dp = math.prod(mesh.shape[a] for a in ("pod", "data")
                     if a in mesh.axis_names)
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    top: list = []

    def add(kind_, b, mult, op):
        b = int(b)
        out[kind_] += b * mult
        counts[kind_] += mult
        top.append({"kind": kind_, "bytes": b, "mult": mult,
                    "total": b * mult, "op": op})

    rows = global_batch // m
    rows = rows // n_dp if rows % n_dp == 0 else rows
    act = rows * (seq_len if kind != "decode" else 1) * cfg.d_model * (
        2 if cfg.dtype == "bfloat16" else 4)
    for path, shape, elem, spec in leaves:
        nbytes = math.prod(shape) * elem
        dp, tp = _split(spec, mesh)
        if dp > 1:
            add("all-gather", nbytes // tp, m * gathers, path)
            if train:
                add("reduce-scatter", nbytes // (dp * tp), m, path)
        elif train and n_dp > 1:
            add("all-reduce", nbytes // tp, m, path)
        if _tp_reduced(path, spec):
            reps = shape[0] if len(shape) > 2 else 1
            add("all-reduce", act, m * (fwd + train) * reps,
                path + " (block output)")
    top.sort(key=lambda d: -d["total"])
    out["_counts"] = counts
    out["_top"] = top[:12]
    return out


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    bytes_per_chip: float          # peak allocation reckoning
    model_flops: float             # 6·N_active·D tokens
    useful_flops_frac: float       # MODEL_FLOPS / (FLOPs · chips)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def roofline_frac(self) -> float:
        """compute_term / max(all terms) — 1.0 means compute-bound at peak."""
        m = max(self.compute_s, self.memory_s, self.collective_s)
        return self.compute_s / m if m > 0 else 0.0


def derive_terms(cost: dict, mem_bytes: float, coll_bytes: float,
                 n_chips: int, model_flops: float) -> RooflineTerms:
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    total_flops = flops * n_chips
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=hbm / HBM_BW,
        collective_s=coll_bytes / LINK_BW,
        flops_per_chip=flops,
        hbm_bytes_per_chip=hbm,
        collective_bytes_per_chip=coll_bytes,
        bytes_per_chip=mem_bytes,
        model_flops=model_flops,
        useful_flops_frac=(model_flops / total_flops
                           if total_flops else 0.0),
    )


def model_flops_for(cfg, shape_kind: str, tokens: int) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE); decode counts one token/seq."""
    n = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens  # forward-only (prefill/decode)


# ---------------------------------------------------------------------------
# First-principles per-cell cost (compute & memory terms), the reference's
# formulas unchanged.
# ---------------------------------------------------------------------------

def analytic_cost(cfg, kind: str, global_batch: int, seq_len: int,
                  n_chips: int, moment_bytes: int = 8) -> dict:
    """Per-chip FLOPs and HBM bytes for one step of ``kind``.

    FLOPs: 2·N_active_matmul per token (fwd), ×3 for train (bwd ≈ 2×fwd),
    plus quadratic attention scores/values (causal → ×1/2), cross-attention,
    SSD intra/inter-chunk terms, and the MoE router.
    HBM bytes (train): weights bf16 read fwd+bwd + grad write/read + AdamW
    moment+master traffic; activations ≈ remat-bound 2 passes of
    c·D bytes/token/layer.  (decode): full weight + KV/state read per token.
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    b, s = global_batch, seq_len
    tokens = b * (s if kind != "decode" else 1)
    fwd_mult = 3.0 if kind == "train" else 1.0

    # matmul params exclude the input embedding gather (not a matmul)
    n_matmul = cfg.active_param_count() - cfg.vocab_size * d
    flops = 2.0 * n_matmul * tokens * fwd_mult

    n_attn = sum(m == "attn" for m, _ in cfg.pattern) * cfg.n_repeats
    n_x = sum(m == "xattn" for m, _ in cfg.pattern) * cfg.n_repeats
    n_mamba = sum(m == "mamba" for m, _ in cfg.pattern) * cfg.n_repeats
    if kind == "decode":
        # per new token: score+value dots over the live cache
        flops += 4.0 * b * s * cfg.n_heads * hd * n_attn
        flops += 4.0 * b * cfg.n_image_tokens * cfg.n_heads * hd * n_x
        if cfg.ssm:
            di = cfg.ssm.expand * d
            flops += 6.0 * b * di * cfg.ssm.state_dim * n_mamba
    else:
        flops += (4.0 * b * s * s * cfg.n_heads * hd * 0.5  # causal
                  * n_attn * fwd_mult)
        flops += (4.0 * b * s * cfg.n_image_tokens * cfg.n_heads * hd
                  * n_x * fwd_mult)
        if cfg.ssm:
            di = cfg.ssm.expand * d
            nh = di // cfg.ssm.head_dim
            L = cfg.ssm.chunk
            nst = cfg.ssm.state_dim
            intra = 2.0 * b * s * L * (nst + nh * cfg.ssm.head_dim * 0.5)
            inter = 4.0 * b * s * di * nst
            flops += (intra + inter) * n_mamba * fwd_mult
    if cfg.moe:
        n_moe = sum(f == "moe" for _, f in cfg.pattern) * cfg.n_repeats
        flops += 2.0 * tokens * d * cfg.moe.num_experts * n_moe * fwd_mult

    # ---- HBM bytes ----
    p_chip = cfg.param_count() / n_chips
    act_bytes_token = 2 * d * 8  # bf16, ~8 block-internal tensors (remat'd)
    n_layers = cfg.n_layers
    if kind == "train":
        weight_traffic = p_chip * 2 * (2 + 2)        # bf16 read fwd+bwd ×2
        opt_traffic = p_chip * (4 * 2 + moment_bytes * 2)  # master rw + m,v rw
        act_traffic = (tokens / n_chips) * act_bytes_token * n_layers * 2
        hbm = weight_traffic + opt_traffic + act_traffic
    elif kind == "prefill":
        hbm = (p_chip * 2 +
               (tokens / n_chips) * act_bytes_token * n_layers +
               2 * b * s * cfg.n_kv_heads * hd * 2 * n_attn / n_chips)
    else:  # decode: read all (sharded) weights + the whole KV cache/state
        kv = 2 * b * s * cfg.n_kv_heads * hd * 2 * n_attn / n_chips
        if cfg.ssm:
            di = cfg.ssm.expand * d
            nh = di // cfg.ssm.head_dim
            kv += (b * nh * cfg.ssm.head_dim * cfg.ssm.state_dim * 4 *
                   n_mamba * 2 / n_chips)
        hbm = p_chip * 2 * (cfg.active_param_count() / cfg.param_count()) + kv
    return {"flops_per_chip": flops / n_chips, "hbm_bytes_per_chip": hbm}
