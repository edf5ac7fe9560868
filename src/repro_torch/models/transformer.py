"""Model assembly: pattern-block decoder over stacked repeats.

PyTorch port of ``repro.models.transformer``.  The parameters form a
:class:`ParamTree`, an ``nn.Module`` whose parameter names are the
reference's tree paths with ``/`` written as ``.`` (``embed.tokens``,
``blocks.3.mixer.wq``, ``final_norm``, ``lm_head``), each block parameter
with the reference's leading ``n_repeats`` dimension; ``ParamTree.tree()``
is the reference's dict/list tree over the same parameters.  The passes
loop over repeats in Python where the reference scans, on the slices one
``torch.unbind`` a leaf takes once per pass: under autograd its backward
stacks the repeats' gradients once, where indexing ``wq[r]`` per repeat
would accumulate a zero-padded whole-leaf gradient per repeat.  With
``cfg.remat == "block"`` (the default) and gradients enabled, ``forward``
recomputes each repeat of the pattern in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so the
activations kept are one ``(B, S, D)`` input a repeat.  ``decode_step``
writes the caches in place, where the reference donates them.

Entry points:
  init_params / forward / loss_fn          — the model and its loss
  init_caches / prefill / decode_step      — serving
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.engine.table import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.embedding import embed_tokens, lm_head_loss_chunked
from repro_torch.models.layers import glu_ffn, init_leaf, rms_norm


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class ParamTree(nn.Module):
    """A node of the reference's parameter tree: a dict's tensors become
    parameters, its dicts children and its lists ``nn.ModuleList``s."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(v))
            elif isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.add_module(name, nn.ModuleList(ParamTree(x) for x in v))

    def tree(self) -> dict:
        """The reference's nested dict/list tree over these parameters
        (the same ``nn.Parameter`` objects)."""
        out: dict = dict(self._parameters)
        for name, m in self._modules.items():
            out[name] = (m.tree() if isinstance(m, ParamTree)
                         else [c.tree() for c in m])
        return out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stacked(tree, r: int, dt: torch.dtype, gen, dev):
    """Draw a tree of (shape, init, dtype) leaves, each stacked ``r``
    times (the reference's vmap over repeats)."""
    if isinstance(tree, dict):
        return {k: _stacked(v, r, dt, gen, dev) for k, v in tree.items()}
    shape, init, d = tree
    return init_leaf((r,) + shape, init, d or dt, generator=gen, device=dev)


def _position_shapes(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    """One pattern position's parameters: name -> (shape, init, dtype) or
    a dict of those (the reference's ``_init_position``)."""
    d = cfg.d_model
    out: dict = {"ln1": ((d,), "zeros", None)}
    if mixer in ("attn", "xattn"):
        out["mixer"] = attn.attn_shapes(cfg)
    elif mixer == "mamba":
        out["mixer"] = ssm.mamba_shapes(cfg)
    else:
        raise ValueError(mixer)
    if ffn == "dense":
        out["ln2"] = ((d,), "zeros", None)
        out["ffn"] = {"w_in": ((d, cfg.d_ff), None, None),
                      "w_gate": ((d, cfg.d_ff), None, None),
                      "w_out": ((cfg.d_ff, d), None, None)}
    elif ffn == "moe":
        out["ln2"] = ((d,), "zeros", None)
        out["ffn"] = moe_mod.moe_shapes(cfg)
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> ParamTree:
    """Random parameters with the reference's distributions (normal x
    fan_in^-0.5, the embedding x 0.02, ``conv_w`` x 0.5; norm gains,
    ``A_log`` and ``dt_bias`` 0, ``D_skip`` 1; the router float32, the rest
    ``cfg.dtype``), drawn from a ``torch.Generator`` seeded with ``seed`` on
    the target device: the card unless ``device`` names another.  On the
    ``meta`` device the tree has its shapes and no storage.  JAX's random
    bits are not reproduced (``convert.params_from_reference`` carries a
    reference tree across)."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    blocks = [_stacked(_position_shapes(cfg, mixer, ffn), cfg.n_repeats, dt,
                       gen, dev) for mixer, ffn in cfg.pattern]
    tree = {
        "embed": {"tokens": init_leaf((cfg.vocab_size, cfg.d_model), 0.02,
                                      dt, generator=gen, device=dev)},
        "blocks": blocks,
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = init_leaf((cfg.d_model, cfg.vocab_size), None, dt,
                                    generator=gen, device=dev)
    return ParamTree(tree)


def _lm_head(cfg: ModelConfig, params: ParamTree) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params.embed.tokens.T
    return params.lm_head


def _repeats(blk: nn.Module, n: int) -> list[dict]:
    """The ``n`` repeats of a stacked pattern position, each a tree of its
    leaves' slices (``{"ln1": ..., "mixer": {"wq": ...}, ...}``), taken with
    one ``torch.unbind`` a leaf."""
    out: list[dict] = [{} for _ in range(n)]
    for name, leaf in blk.named_parameters():
        *path, last = name.split(".")
        for node, piece in zip(out, leaf.unbind(0)):
            for k in path:
                node = node.setdefault(k, {})
            node[last] = piece
    return out


def _layer(node: dict, cls):
    """A repeat's mixer or FFN slices as ``cls``."""
    return cls(**{f: node[f] for f in cls._fields})


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _mixer_prefill(cfg: ModelConfig, p: dict, mixer: str,
                   h: torch.Tensor, positions: torch.Tensor,
                   image_embeds: torch.Tensor | None):
    """A mixer over the whole sequence: (output, the layer's cache)."""
    b, s = h.shape[:2]
    dt = _dtype(cfg)
    if mixer == "mamba":
        return ssm.mamba_forward(_layer(p["mixer"], ssm.MambaParams), cfg, h)
    ap = _layer(p["mixer"], attn.AttnParams)
    if mixer == "attn":
        q, k, v = attn._project_qkv(ap, cfg, h, positions)
        o = attn.blockwise_attention(q, k, v, causal=True,
                                     chunk=cfg.attn_chunk)
    else:
        q, k, v = attn._project_qkv(ap, cfg, h, positions, kv_x=image_embeds,
                                    use_rope=False)
        o = attn.blockwise_attention(
            q, k, v, causal=False,
            chunk=min(cfg.attn_chunk, image_embeds.shape[1]))
    return o.reshape(b, s, -1) @ ap.wo, attn.KVCache(k.to(dt), v.to(dt))


def _ffn(cfg: ModelConfig, p: dict, ffn: str,
         x: torch.Tensor) -> torch.Tensor:
    if ffn == "none":
        return x
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if ffn == "dense":
        w = p["ffn"]
        f = glu_ffn(h2, w["w_in"], w["w_gate"], w["w_out"], cfg.act)
    else:
        f = moe_mod.moe_ffn(_layer(p["ffn"], moe_mod.MoEParams), cfg, h2,
                            cfg.act)
    return x + f


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def forward(cfg: ModelConfig, params: ParamTree, tokens: torch.Tensor,
            image_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: (B, S) -> hidden states (B, S, D)."""
    b, s = tokens.shape
    x = embed_tokens(params.embed.tokens, tokens, dedup=cfg.dedup_embed)
    positions = _positions(b, s, x.device)
    reps = [_repeats(blk, cfg.n_repeats) for blk in params.blocks]

    def block_fn(x: torch.Tensor, ps: list[dict]) -> torch.Tensor:
        for p, (mixer, ffn) in zip(ps, cfg.pattern):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            mx, _ = _mixer_prefill(cfg, p, mixer, h, positions, image_embeds)
            x = _ffn(cfg, p, ffn, x + mx)
        return x

    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for r in range(cfg.n_repeats):
        ps = [rep[r] for rep in reps]
        if remat:
            # the pass draws no random numbers: no RNG state to replay
            x = checkpoint(block_fn, x, ps, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block_fn(x, ps)
    return rms_norm(x, params.final_norm, cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params: ParamTree, tokens: torch.Tensor,
            labels: torch.Tensor,
            image_embeds: torch.Tensor | None = None) -> torch.Tensor:
    h = forward(cfg, params, tokens, image_embeds)
    return lm_head_loss_chunked(h, _lm_head(cfg, params), labels,
                                cfg.loss_chunk)


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                n_image_tokens: int = 0, device=None) -> list:
    """Zeroed caches, one per pattern position, each a ``KVCache`` or
    ``MambaState`` of stacked ``(n_repeats, …)`` tensors, on the card unless
    ``device`` names another."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    r = cfg.n_repeats
    caches = []
    for mixer, _ in cfg.pattern:
        if mixer == "attn":
            c = attn.init_kv_cache(batch, max_seq, cfg, dt, dev)
        elif mixer == "xattn":
            c = attn.init_kv_cache(batch, max(n_image_tokens, 1), cfg, dt,
                                   dev)
        else:
            c = ssm.init_mamba_state(batch, cfg, dt, dev)
        caches.append(type(c)(*(a[None].repeat((r,) + (1,) * a.dim())
                                for a in c)))
    return caches


@torch.no_grad()
def prefill(cfg: ModelConfig, params: ParamTree, tokens: torch.Tensor,
            max_seq: int | None = None,
            image_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, list]:
    """Run the prompt, return (last-token logits (B, V) float32, caches
    with ``max_seq`` attention positions)."""
    b, s = tokens.shape
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} is shorter than the prompt {s}")
    x = embed_tokens(params.embed.tokens, tokens, dedup=cfg.dedup_embed)
    positions = _positions(b, s, x.device)
    n_img = image_embeds.shape[1] if image_embeds is not None else 0
    caches = init_caches(cfg, b, max_seq, n_img, device=x.device)
    reps = [_repeats(blk, cfg.n_repeats) for blk in params.blocks]
    for r in range(cfg.n_repeats):
        for rep, c, (mixer, ffn) in zip(reps, caches, cfg.pattern):
            p = rep[r]
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            mx, layer = _mixer_prefill(cfg, p, mixer, h, positions,
                                       image_embeds)
            for full, part in zip(c, layer):
                full[r, :, :part.shape[1]] = part
            x = _ffn(cfg, p, ffn, x + mx)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = (x[:, -1, :] @ _lm_head(cfg, params)).float()
    return logits, caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: ParamTree, caches: list,
                token: torch.Tensor, pos: int) -> tuple[torch.Tensor, list]:
    """One-token decode.  token: (B, 1); pos: int, the token's position.

    Updates ``caches`` in place and returns (logits (B, V), caches).  A
    position past an attention cache raises before anything is written
    (the reference clamps it to the last slot).
    """
    b = token.shape[0]
    pos = int(pos)
    for c, (mixer, _) in zip(caches, cfg.pattern):
        if mixer == "attn" and not 0 <= pos < c.k.shape[2]:
            raise IndexError(f"decode position {pos} is outside the cache "
                             f"of {c.k.shape[2]} positions")
    x = embed_tokens(params.embed.tokens, token, dedup=cfg.dedup_embed)
    hd = cfg.resolved_head_dim
    reps = [_repeats(blk, cfg.n_repeats) for blk in params.blocks]
    for r in range(cfg.n_repeats):
        for rep, c, (mixer, ffn) in zip(reps, caches, cfg.pattern):
            p = rep[r]
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            if mixer == "attn":
                mx, _ = attn.decode_attention(
                    _layer(p["mixer"], attn.AttnParams), cfg, h,
                    attn.KVCache(c.k[r], c.v[r]), pos)
            elif mixer == "xattn":
                ap = _layer(p["mixer"], attn.AttnParams)
                q = (h @ ap.wq).reshape(b, 1, cfg.n_heads, hd)
                if cfg.qk_norm:
                    q = rms_norm(q, ap.q_norm, cfg.norm_eps)
                o = attn.blockwise_attention(
                    q, c.k[r], c.v[r], causal=False,
                    chunk=min(cfg.attn_chunk, c.k.shape[2]))
                mx = o.reshape(b, 1, -1) @ ap.wo
            else:
                mx, st = ssm.mamba_decode(
                    _layer(p["mixer"], ssm.MambaParams), cfg, h,
                    ssm.MambaState(c.h[r], c.conv[r]))
                c.h[r] = st.h
                c.conv[r] = st.conv
            x = _ffn(cfg, p, ffn, x + mx)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = (x[:, -1, :] @ _lm_head(cfg, params)).float()
    return logits, caches
