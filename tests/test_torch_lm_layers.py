"""The port's LM layers against the JAX package's, on the CPU.

Same inputs (seeded numpy or ``jax.random`` arrays) through each JAX layer
and its port.  Tolerances: ``blockwise_attention`` atol 2e-5 / rtol 1e-4
and MoE atol 1e-5 / rtol 1e-4 (the reference's own, ``tests/
test_layers.py``); SSD, Mamba and the other layers tighter than the
reference's SSD 1e-3 (float32 reductions in another order); bfloat16 one
unit in the last place.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke as jsmoke
from repro.models import attention as jattn
from repro.models import embedding as jemb
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro_torch.configs import smoke
from repro_torch.models import attention, embedding, layers, moe, ssm
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.convert import tensor_from_numpy

KEY = jax.random.PRNGKey(0)


def t(a):
    """A JAX or numpy array as a CPU tensor, bit for bit."""
    return tensor_from_numpy(np.asarray(a), "cpu")


def close(got, want, atol, rtol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def params_of(cls, jp):
    return cls(*(t(a) for a in jp))


# --------------------------------------------------------------------------
# norms, rope, GLU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 5, 16)) * 3, dtype)
    gain = jnp.asarray(rng.normal(size=(16,)), dtype)
    want = jlayers.rms_norm(x, gain, 1e-6)
    got = layers.rms_norm(t(x), t(gain), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        close(got, want, 1e-6, 1e-6)
    else:   # one bfloat16 unit in the last place
        close(got, want, 0, 2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 64, 4, 16)), dtype)
    pos = jnp.asarray(np.broadcast_to(np.arange(64)[None], (2, 64)))
    want = jlayers.rope(x, pos, 10_000.0)
    got = layers.rope(t(x), t(pos), 10_000.0)
    if dtype == "float32":
        close(got, want, 2e-5, 1e-5)
    else:
        close(got, want, 2 ** -7, 2 ** -7)


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_glu_ffn_matches_reference(act):
    rng = np.random.default_rng(3)
    x, wi, wg, wo = (jnp.asarray(rng.normal(size=s), jnp.float32)
                     for s in ((2, 7, 16), (16, 32), (16, 32), (32, 16)))
    want = jlayers.glu_ffn(x, wi, wg, wo, act)
    got = layers.glu_ffn(t(x), t(wi), t(wg), t(wo), act)
    close(got, want, 1e-5, 1e-5)


def test_geglu_is_the_tanh_gelu():
    """``jax.nn.gelu`` defaults to the tanh form; torch's default (erf)
    differs by ~1e-3, more than every tolerance here."""
    g = np.linspace(-4, 4, 101, dtype=np.float32)
    close(layers.activation(torch.from_numpy(g), "geglu"),
          jax.nn.gelu(jnp.asarray(g)), 1e-6, 1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(g))
    assert float((erf - layers.activation(torch.from_numpy(g), "geglu"))
                 .abs().max()) > 1e-4


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("skv,chunk", [(64, 16), (64, 64), (37, 16)])
def test_blockwise_attention_matches_reference(causal, skv, chunk):
    ks = jax.random.split(KEY, 3)
    q = jax.random.normal(ks[0], (2, skv if causal else 5, 8, 16))
    k = jax.random.normal(ks[1], (2, skv, 2, 16))
    v = jax.random.normal(ks[2], (2, skv, 2, 16))
    want = jattn.blockwise_attention(q, k, v, causal=causal, chunk=chunk)
    got = attention.blockwise_attention(t(q), t(k), t(v), causal=causal,
                                        chunk=chunk)
    close(got, want, 2e-5, 1e-4)


def test_attention_layers_match_reference():
    """``self_attention`` (qk-norm, GQA, rope), ``cross_attention`` over a
    ragged image stream, and ``decode_attention`` writing its cache."""
    cfg = smoke("qwen3-4b")
    jcfg = jsmoke("qwen3-4b")
    jp = jattn.init_attn(KEY, jcfg, jnp.float32)
    jp = jp._replace(q_norm=jax.random.normal(KEY, jp.q_norm.shape) * 0.1,
                     k_norm=jax.random.normal(KEY, jp.k_norm.shape) * 0.1)
    p = params_of(attention.AttnParams, jp)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(2, 12, cfg.d_model)), jnp.float32)
    img = jnp.asarray(rng.normal(size=(2, 37, cfg.d_model)), jnp.float32)
    pos = jnp.asarray(np.broadcast_to(np.arange(12)[None], (2, 12)))
    close(attention.self_attention(p, cfg, t(x), t(pos)),
          jattn.self_attention(jp, jcfg, x, pos), 2e-5, 1e-4)
    close(attention.cross_attention(p, cfg, t(x), t(img)),
          jattn.cross_attention(jp, jcfg, x, img), 2e-5, 1e-4)
    jc = jattn.KVCache(jnp.asarray(rng.normal(size=(2, 16, 2, 16)),
                                   jnp.float32),
                       jnp.asarray(rng.normal(size=(2, 16, 2, 16)),
                                   jnp.float32))
    c = attention.KVCache(t(jc.k).clone(), t(jc.v).clone())
    want, jc2 = jattn.decode_attention(jp, jcfg, x[:, :1], jc, 9)
    got, c2 = attention.decode_attention(p, cfg, t(x[:, :1]), c, 9)
    close(got, want, 2e-5, 1e-4)
    close(c2.k, jc2.k, 2e-5, 1e-5)
    close(c2.v, jc2.v, 2e-5, 1e-5)
    assert c2.k is c.k     # written in place


def test_decode_attention_past_the_cache_raises():
    """The reference's ``dynamic_update_slice`` clamps a start past the
    cache to its last slot (ROADMAP Queue 3); the port raises."""
    cfg = smoke("qwen3-4b")
    p = attention.init_attn(cfg, torch.float32, device="cpu")
    c = attention.init_kv_cache(2, 16, cfg, torch.float32, "cpu")
    x = torch.randn(2, 1, cfg.d_model)
    with pytest.raises(IndexError, match="outside the cache"):
        attention.decode_attention(p, cfg, x, c, 16)
    jcfg = jsmoke("qwen3-4b")
    jp = jattn.init_attn(KEY, jcfg, jnp.float32)
    jc = jattn.init_kv_cache(2, 16, jcfg, jnp.float32)
    _, jc2 = jattn.decode_attention(jp, jcfg, jnp.asarray(x.numpy()), jc, 16)
    assert float(jnp.abs(jc2.k[:, 15]).sum()) > 0   # the last slot taken


# --------------------------------------------------------------------------
# Mamba2 SSD
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 32), (64, 16)])
def test_ssd_scan_matches_reference(s, chunk):
    ks = jax.random.split(KEY, 4)
    b, nh, hd, n = 2, 3, 4, 5
    x = jax.random.normal(ks[0], (b, s, nh, hd))
    dt = jax.nn.softplus(jax.random.normal(ks[1], (b, s, nh)))
    a_log = jax.random.normal(ks[1], (nh,)) * 0.3
    bm = jax.random.normal(ks[2], (b, s, n))
    cm = jax.random.normal(ks[3], (b, s, n))
    y_ref, h_ref = jssm.ssd_scan(x, dt, a_log, bm, cm, chunk)
    y, h = ssm.ssd_scan(t(x), t(dt), t(a_log), t(bm), t(cm), chunk)
    close(y, y_ref, 1e-4, 1e-4)
    close(h, h_ref, 1e-4, 1e-4)


def test_ssd_scan_rejects_a_partial_chunk():
    x = torch.zeros(1, 24, 2, 4)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssm.ssd_scan(x, torch.ones(1, 24, 2), torch.zeros(2),
                     torch.zeros(1, 24, 3), torch.zeros(1, 24, 3), 16)


@pytest.mark.parametrize("s", [32, 2])
def test_mamba_forward_and_decode_match_reference(s):
    """Prefill (conv tail padded to ``w-1`` when ``s < w-1``) and three
    decode steps from its state."""
    cfg, jcfg = smoke("mamba2-780m"), jsmoke("mamba2-780m")
    jp = jssm.init_mamba(KEY, jcfg, jnp.float32)
    ks = jax.random.split(KEY, 3)
    jp = jp._replace(A_log=jax.random.normal(ks[0], jp.A_log.shape) * 0.3,
                     dt_bias=jax.random.normal(ks[1], jp.dt_bias.shape),
                     ssm_norm=jax.random.normal(ks[2], jp.ssm_norm.shape))
    p = params_of(ssm.MambaParams, jp)
    x = jax.random.normal(KEY, (2, s + 3, cfg.d_model))
    want, jst = jssm.mamba_forward(jp, jcfg, x[:, :s])
    got, st = ssm.mamba_forward(p, cfg, t(x[:, :s]))
    close(got, want, 1e-4, 1e-4)
    close(st.h, jst.h, 1e-4, 1e-4)
    close(st.conv, jst.conv, 1e-5, 1e-5)
    for i in range(s, s + 3):
        want, jst = jssm.mamba_decode(jp, jcfg, x[:, i:i + 1], jst)
        got, st = ssm.mamba_decode(p, cfg, t(x[:, i:i + 1]), st)
        close(got, want, 1e-4, 1e-4)
        close(st.h, jst.h, 1e-4, 1e-4)
        close(st.conv, jst.conv, 1e-5, 1e-5)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _moe_cfgs(capacity_factor=8.0, groups=1):
    kw = dict(name="t", n_layers=2, d_model=16, n_heads=2, n_kv_heads=2,
              d_ff=32, vocab_size=64, pattern=(("attn", "moe"),),
              moe_groups=groups)
    return (ModelConfig(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=8,
                                      capacity_factor=capacity_factor), **kw),
            JModelConfig(moe=JMoEConfig(num_experts=4, top_k=2,
                                        d_ff_expert=8,
                                        capacity_factor=capacity_factor),
                         **kw))


@pytest.fixture(scope="module")
def moe_params():
    cfg, jcfg = _moe_cfgs()
    jp = jmoe.init_moe(KEY, jcfg, jnp.float32)
    return jp, params_of(moe.MoEParams, jp)


def _same_routing(jp, p, x, k):
    """Both packages send every token to the same experts: a ``top_k`` tie
    broken differently shows here, not as a tolerance miss."""
    xf = x.reshape(-1, x.shape[-1])
    _, jtop = jax.lax.top_k(xf.astype(jnp.float32) @ jp.router, k)
    topi, _ = moe._route(p, t(xf), k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtop))


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
@pytest.mark.parametrize("cf,s", [(8.0, 8), (0.25, 32)],
                         ids=["ample", "drops"])
def test_moe_binned_matches_reference(moe_params, act, cf, s):
    jp, p = moe_params
    cfg, jcfg = _moe_cfgs(cf)
    x = jax.random.normal(KEY, (2, s, 16))
    _same_routing(jp, p, x, 2)
    want = jmoe.moe_ffn(jp, jcfg, x, act)
    got = moe.moe_ffn(p, cfg, t(x), act)
    close(got, want, 1e-5, 1e-4)
    if cf == 8.0:   # no drops: the binned path equals the dense oracle
        close(got, moe.moe_ffn_dense_fallback(p, cfg, t(x), act).detach(),
              1e-5, 1e-4)
    else:           # drops reduce the output, never NaN
        full = moe.moe_ffn_dense_fallback(p, cfg, t(x), act)
        assert bool(torch.isfinite(got).all())
        assert float(got.norm()) < float(full.norm())


@pytest.mark.parametrize("groups", [4, 8])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_moe_grouped_matches_reference(moe_params, groups, cf):
    """The grouped one-device path.  At cf 1.25 the reference's grouped
    capacity, rounded down to a multiple of 8, drops assignments (16 slots
    an expert at 4 groups, where ``_capacity`` would give 24)."""
    jp, p = moe_params
    cfg, jcfg = _moe_cfgs(cf, groups)
    x = jax.random.normal(KEY, (2, 64, 16))
    _same_routing(jp, p, x, 2)
    want = jmoe.moe_ffn(jp, jcfg, x)
    got = moe.moe_ffn(p, cfg, t(x))
    close(got, want, 1e-5, 1e-4)


def test_moe_dense_fallback_and_skew_stats_match_reference(moe_params):
    jp, p = moe_params
    cfg, jcfg = _moe_cfgs()
    x = jax.random.normal(KEY, (2, 16, 16))
    for act in ("swiglu", "geglu"):
        close(moe.moe_ffn_dense_fallback(p, cfg, t(x), act),
              jmoe.moe_ffn_dense_fallback(jp, jcfg, x, act), 1e-5, 1e-4)
    logits = jax.random.normal(KEY, (64, 4)) + jnp.asarray([2., 0, 0, -3])
    want = jmoe.routing_skew_stats(logits, 2)
    got = moe.routing_skew_stats(t(logits), 2)
    for k in ("max_over_mean", "frac_empty"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6)


def test_moe_capacity_rounds_like_reference():
    for n in (1, 7, 16, 100, 333, 2048):
        for cf in (0.25, 1.0, 1.25, 8.0):
            mc = MoEConfig(num_experts=16, top_k=2, d_ff_expert=8,
                           capacity_factor=cf)
            jmc = JMoEConfig(num_experts=16, top_k=2, d_ff_expert=8,
                             capacity_factor=cf)
            assert moe._capacity(n, mc) == jmoe._capacity(n, jmc)


# --------------------------------------------------------------------------
# embedding and loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dedup", [True, False])
def test_embed_tokens_matches_reference(dedup):
    rng = np.random.default_rng(5)
    table = jnp.asarray(rng.normal(size=(512, 64)), jnp.float32)
    ids = jnp.asarray(rng.zipf(1.3, size=(3, 40)) % 512, jnp.int32)
    want = jemb.embed_tokens(table, ids, dedup=dedup)
    got = embedding.embed_tokens(t(table), t(ids), dedup=dedup)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), embedding.embed_tokens(t(table), t(ids),
                                            dedup=not dedup).numpy())


@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8), (16, 64)])
def test_lm_head_loss_matches_reference(s, chunk):
    rng = np.random.default_rng(6)
    h = jnp.asarray(rng.normal(size=(2, s, 16)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(16, 50)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, 50, size=(2, s)), jnp.int32)
    want = jemb.lm_head_loss_chunked(h, w, labels, chunk)
    got = embedding.lm_head_loss_chunked(t(h), t(w), t(labels), chunk)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_dense_init_follows_reference_distribution():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init((3, 256, 512), torch.float32, generator=gen)
    assert abs(float(w.std()) - 256 ** -0.5) < 2e-3
    assert abs(float(w.mean())) < 1e-3
    e = layers.dense_init((1000, 64), torch.bfloat16, 0.02, generator=gen)
    assert e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) - 0.02) < 1e-3
    assert layers.dense_init((4, 8), torch.float32, device="meta").is_meta
