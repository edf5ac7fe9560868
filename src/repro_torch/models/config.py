"""Composable model configuration covering all assigned architecture families.

PyTorch port of ``repro.models.config``, copied field for field (the port
imports nothing of the reference).  A model is a repeating ``pattern`` of
(mixer, ffn) blocks over ``n_layers`` — dense transformers, MoE, SSM
(Mamba2 SSD), hybrid (Jamba), VLM cross-attention, and audio-token decoders
are all instances.  The sharding knobs (``fsdp_axes``, ``moe_groups``,
``sp``) and ``remat`` are kept for parity; of them only ``moe_groups``
(and, under an active mesh, whether the MoE takes its manual dispatch)
changes what is computed.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "mamba", "xattn"]
Ffn = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # JSPIM integration: sort-by-expert binned dispatch (the coalescing /
    # bucket-binning schedule) is always on; this toggles the fallback
    # dense-masked dispatch for A/B comparison.
    binned_dispatch: bool = True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128  # SSD intra-chunk (quadratic) span


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    pattern: tuple[tuple[Mixer, Ffn], ...] = (("attn", "dense"),)
    act: str = "swiglu"          # swiglu | geglu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # VLM stub frontend: number of precomputed patch-embedding tokens the
    # cross-attention layers attend to (input_specs() supplies them)
    n_image_tokens: int = 0
    dtype: str = "bfloat16"
    # distribution knobs (see launch/sharding.py)
    fsdp_axes: tuple[str, ...] = ("data",)
    remat: str = "block"         # none | block
    # JSPIM integration: dedup the (Zipf-skewed) token stream before the
    # embedding gather, scatter results back through the inverse permutation
    dedup_embed: bool = True
    # grouped (dp-local) MoE dispatch: 1 = global sort; >1 = hierarchical
    # per-shard binning (set to the dp size by the launcher)
    moe_groups: int = 1
    # sequence parallelism: shard block-boundary activations over the model
    # axis on the sequence dim (converts TP all-reduces into
    # reduce-scatter/all-gather pairs at 1/tp the per-chip bytes)
    sp: bool = False
    attn_chunk: int = 1024       # blockwise-attention KV chunk
    loss_chunk: int = 512        # vocab-logits sequence chunking

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}")
        if any(f == "moe" for _, f in self.pattern):
            assert self.moe is not None
        if any(m == "mamba" for m, _ in self.pattern):
            assert self.ssm is not None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def is_attention_free(self) -> bool:
        return all(m == "mamba" for m, _ in self.pattern)

    @property
    def has_subquadratic_path(self) -> bool:
        """True when long-context decode is state-based (SSM/hybrid)."""
        return any(m == "mamba" for m, _ in self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for mixer, ffn in self.pattern:
            n = 0
            if mixer == "attn":
                n += d * hd * (self.n_heads + 2 * self.n_kv_heads)  # q,k,v
                n += self.n_heads * hd * d                          # o
            elif mixer == "xattn":
                n += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                n += self.n_heads * hd * d
            elif mixer == "mamba":
                di = self.ssm.expand * d
                nh = di // self.ssm.head_dim
                n += d * (2 * di + 2 * self.ssm.state_dim + nh)  # in_proj
                n += di * d                                       # out_proj
                n += (di + 2 * self.ssm.state_dim) * self.ssm.conv_width
            if ffn == "dense":
                n += 3 * d * self.d_ff
            elif ffn == "moe":
                n += self.moe.num_experts * 3 * d * self.moe.d_ff_expert
                n += d * self.moe.num_experts                     # router
            n += 2 * d                                            # norms
            total += n * self.n_repeats
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        moe_blocks = sum(1 for _, f in self.pattern if f == "moe")
        expert_total = (moe_blocks * self.n_repeats *
                        self.moe.num_experts * 3 * self.d_model *
                        self.moe.d_ff_expert)
        expert_active = (moe_blocks * self.n_repeats *
                         self.moe.top_k * 3 * self.d_model *
                         self.moe.d_ff_expert)
        return full - expert_total + expert_active
