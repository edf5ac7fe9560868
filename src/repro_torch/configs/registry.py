"""The 10 assigned architectures, exact configs from the assignment table.

PyTorch port of ``repro.configs.registry``: the same literal configs.
Where the public config omits a field (head_dim), the published model's value
is used and noted.  ``smoke()`` returns a reduced same-family config for CPU
tests; a full config is built on the card (``chip_smoke.py``) or on the
``meta`` device (parameter counts, no memory).
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

_REGISTRY: dict[str, ModelConfig] = {}


def _reg(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# --- MoE -------------------------------------------------------------------
# Kimi K2: trillion-param MoE [arXiv:2501.kimi2]. head_dim=128 (published
# value; the assignment leaves it implicit).  MoE on every layer.
KIMI_K2 = _reg(ModelConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, head_dim=128, d_ff=2048, vocab_size=163840,
    pattern=(("attn", "moe"),),
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048),
    fsdp_axes=("pod", "data")))

# Llama-4 Maverick: MoE interleaved every 2nd layer (matches 400B total /
# 17B active with the assignment's 128e top-1, d_ff=8192).
LLAMA4 = _reg(ModelConfig(
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=202048,
    pattern=(("attn", "dense"), ("attn", "moe")),
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192),
    fsdp_axes=("pod", "data")))

# --- dense -----------------------------------------------------------------
MINITRON = _reg(ModelConfig(
    name="minitron-4b", n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    head_dim=128, d_ff=9216, vocab_size=256000))

GEMMA = _reg(ModelConfig(
    name="gemma-7b", n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    head_dim=256, d_ff=24576, vocab_size=256000, act="geglu"))

QWEN3_4B = _reg(ModelConfig(
    name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=9728, vocab_size=151936, qk_norm=True))

QWEN3_32B = _reg(ModelConfig(
    name="qwen3-32b", n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=25600, vocab_size=151936, qk_norm=True))

# --- hybrid: Jamba (1 attn : 7 mamba per 8-layer block, MoE every other) ---
JAMBA = _reg(ModelConfig(
    name="jamba-v0.1-52b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=65536,
    pattern=(("mamba", "dense"), ("mamba", "moe"),
             ("mamba", "dense"), ("attn", "moe"),
             ("mamba", "dense"), ("mamba", "moe"),
             ("mamba", "dense"), ("mamba", "moe")),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2)))

# --- VLM: cross-attention image layers every 5th layer; image patch
# embeddings are a stub input (precomputed by input_specs) ------------------
LLAMA32_VISION = _reg(ModelConfig(
    name="llama-3.2-vision-11b", n_layers=40, d_model=4096, n_heads=32,
    n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=128256,
    pattern=(("attn", "dense"),) * 4 + (("xattn", "dense"),),
    n_image_tokens=1601))

# --- SSM: Mamba2 (SSD) ------------------------------------------------------
MAMBA2 = _reg(ModelConfig(
    name="mamba2-780m", n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280, pattern=(("mamba", "none"),),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2),
    tie_embeddings=True))

# --- audio: MusicGen (decoder-only over EnCodec tokens; frontend stubbed) --
MUSICGEN = _reg(ModelConfig(
    name="musicgen-large", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=2048))


def list_archs() -> list[str]:
    return list(_REGISTRY.keys())


def get_config(name: str) -> ModelConfig:
    return _REGISTRY[name]


def smoke(name: str) -> ModelConfig:
    """Reduced same-family config: small widths/experts, one pattern repeat
    per two layers, tiny vocab — runs a CPU forward/train step in seconds."""
    import dataclasses
    cfg = get_config(name)
    plen = len(cfg.pattern)
    # capacity_factor 8: drops impossible at smoke scale, so the training
    # path and the (drop-free) decode path agree exactly in tests
    moe = cfg.moe and MoEConfig(num_experts=4, top_k=min(cfg.moe.top_k, 2),
                                d_ff_expert=64, capacity_factor=8.0,
                                binned_dispatch=cfg.moe.binned_dispatch)
    ssm = cfg.ssm and SSMConfig(state_dim=8, head_dim=8, expand=2, chunk=16)
    return dataclasses.replace(
        cfg,
        n_layers=plen * 2 if plen > 1 else 2,
        d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        head_dim=16, d_ff=0 if cfg.d_ff == 0 else 128, vocab_size=512,
        moe=moe, ssm=ssm,
        n_image_tokens=16 if cfg.n_image_tokens else 0,
        attn_chunk=32, loss_chunk=32, dtype="float32")
