"""GQA attention: blockwise (online-softmax) prefill path + cached decode.

PyTorch port of ``repro.models.attention``.  The prefill path streams KV in
chunks with an online-softmax accumulator (a Python loop over chunks where
the reference scans), so peak memory is O(S · chunk) instead of O(S²).  The
einsums run in float32; on the card they stay true float32 (the port
leaves ``torch.backends.cuda.matmul.allow_tf32`` at its default, False).
``NEG_INF`` is finite: with ``-inf`` a fully masked chunk would turn into
NaN through ``exp(m - m_new)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_leaf, rms_norm, rope

NEG_INF = -1e30


class AttnParams(NamedTuple):
    wq: torch.Tensor   # (D, H*hd)
    wk: torch.Tensor   # (D, KH*hd)
    wv: torch.Tensor   # (D, KH*hd)
    wo: torch.Tensor   # (H*hd, D)
    q_norm: torch.Tensor  # (hd,) — used when cfg.qk_norm
    k_norm: torch.Tensor  # (hd,)


def attn_shapes(cfg: ModelConfig) -> dict:
    """Each parameter's (shape, init, dtype or None for the model's), for
    ``layers.init_leaf``."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    return {"wq": ((d, cfg.n_heads * hd), None, None),
            "wk": ((d, cfg.n_kv_heads * hd), None, None),
            "wv": ((d, cfg.n_kv_heads * hd), None, None),
            "wo": ((cfg.n_heads * hd, d), None, None),
            "q_norm": ((hd,), "zeros", None),
            "k_norm": ((hd,), "zeros", None)}


def init_attn(cfg: ModelConfig, dtype: torch.dtype, *,
              generator: torch.Generator | None = None,
              device=None) -> AttnParams:
    return AttnParams(**{
        k: init_leaf(shape, init, dt or dtype, generator=generator,
                     device=device)
        for k, (shape, init, dt) in attn_shapes(cfg).items()})


def _project_qkv(p: AttnParams, cfg: ModelConfig, x, positions,
                 kv_x=None, use_rope=True):
    """Returns q: (B,S,H,hd), k/v: (B,Skv,KH,hd)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    kv_in = x if kv_x is None else kv_x
    q = (x @ p.wq).reshape(b, s, cfg.n_heads, hd)
    k = (kv_in @ p.wk).reshape(b, kv_in.shape[1], cfg.n_kv_heads, hd)
    v = (kv_in @ p.wv).reshape(b, kv_in.shape[1], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        kv_pos = (positions if kv_x is None
                  else torch.arange(kv_in.shape[1], device=x.device)[None])
        k = rope(k, kv_pos, cfg.rope_theta)
    return q, k, v


def blockwise_attention(q, k, v, *, causal: bool, chunk: int,
                        q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, hd); k, v: (B, Skv, KH, hd); GQA via head grouping (query
    head ``h`` reads KV head ``h // g``).  ``q_offset`` is the absolute
    position of q[0] for causal masking.
    """
    b, sq, h, hd = q.shape
    skv_real, kh = k.shape[1], k.shape[2]
    g = h // kh
    dev = q.device
    qg = q.reshape(b, sq, kh, g, hd).float()
    scale = hd ** -0.5
    chunk = min(chunk, skv_real)
    n_chunks = -(-skv_real // chunk)  # a ragged tail (1601 image tokens)
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, sq, kh, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, kh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, kh, g, hd), dtype=torch.float32, device=dev)
    for c_idx in range(n_chunks):
        lo = c_idx * chunk
        kb = k[:, lo:lo + chunk].float()
        vb = v[:, lo:lo + chunk].float()
        pad = chunk - kb.shape[1]
        if pad:  # the reference's zero padding, masked below
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        s_ = torch.einsum("bqkgd,bckd->bqkgc", qg, kb) * scale
        kv_pos = lo + torch.arange(chunk, device=dev)
        mask = (kv_pos[None, :] < skv_real).expand(sq, chunk)
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        s_ = torch.where(mask[None, :, None, None, :], s_, NEG_INF)
        m_new = torch.maximum(m, s_.amax(dim=-1))
        p_ = torch.exp(s_ - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p_.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd",
                                                   p_, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def self_attention(p: AttnParams, cfg: ModelConfig, x,
                   positions) -> torch.Tensor:
    q, k, v = _project_qkv(p, cfg, x, positions)
    o = blockwise_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    b, s = x.shape[:2]
    return o.reshape(b, s, -1) @ p.wo


def cross_attention(p: AttnParams, cfg: ModelConfig, x,
                    kv_x) -> torch.Tensor:
    """VLM cross-attn: queries from text stream, KV from image embeddings."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x,
                           torch.arange(s, device=x.device)[None],
                           kv_x=kv_x, use_rope=False)
    o = blockwise_attention(q, k, v, causal=False,
                            chunk=min(cfg.attn_chunk, kv_x.shape[1]))
    return o.reshape(b, s, -1) @ p.wo


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KH, hd)
    v: torch.Tensor  # (B, S_max, KH, hd)


def init_kv_cache(batch, max_seq, cfg: ModelConfig, dtype,
                  device=None) -> KVCache:
    hd = cfg.resolved_head_dim
    shape = (batch, max_seq, cfg.n_kv_heads, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def decode_attention(p: AttnParams, cfg: ModelConfig, x, cache: KVCache,
                     pos: int) -> tuple[torch.Tensor, KVCache]:
    """One-token decode: write the new K/V into ``cache`` at ``pos`` (in
    place), attend over the valid prefix ``[0, pos]``.

    x: (B, 1, D); pos: int — current position.  The reference's
    ``dynamic_update_slice`` clamps a start past the cache to its last slot
    and silently overwrites it; the port raises instead.
    """
    b = x.shape[0]
    pos = int(pos)
    s_max = cache.k.shape[1]
    if not 0 <= pos < s_max:
        raise IndexError(f"decode position {pos} is outside the cache of "
                         f"{s_max} positions")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    cache.k[:, pos:pos + 1] = k_new.to(cache.k.dtype)
    cache.v[:, pos:pos + 1] = v_new.to(cache.v.dtype)
    hd = cfg.resolved_head_dim
    kh = cfg.n_kv_heads
    g = cfg.n_heads // kh
    qg = q.reshape(b, kh, g, hd).float()
    # positions past ``pos`` are masked to NEG_INF in the reference: their
    # weights are exactly 0, so the valid prefix alone gives the softmax
    k = cache.k[:, :pos + 1].float()
    v = cache.v[:, :pos + 1].float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k) * hd ** -0.5
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, v)
    o = o.reshape(b, 1, cfg.n_heads * hd).to(x.dtype)
    return o @ p.wo, cache
