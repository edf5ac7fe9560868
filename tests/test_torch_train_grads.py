"""Gradients of the port's models against the JAX package's, on the CPU.

For the qwen3-4b, mamba2-780m and jamba ``smoke()`` configs (float32,
2 x 64 tokens) the JAX parameters are carried across with
``params_from_reference``; the loss and every leaf's gradient must match
``jax.value_and_grad`` within 1e-4 of the leaf's largest |g| (float32
sums in another order through 2-16 layers and a backward; measured
1.6e-6 / 2.3e-6 / 6.8e-5).  A leaf autograd leaves without ``.grad``
counts as zeros, and must be zero in JAX.  Block remat and none give
bit-identical gradients (the same kernels recompute the same values).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _path_str
from repro.configs import smoke as jsmoke
from repro.models.transformer import init_params as jinit_params
from repro.models.transformer import loss_fn as jloss_fn
from repro_torch.configs import smoke
from repro_torch.models import loss_fn, params_from_reference
from repro_torch.optim import OptConfig
from repro_torch.train import init_train_state

GRAD_TOL = 1e-4
ARCHS = ("qwen3-4b", "mamba2-780m", "jamba-v0.1-52b")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _port_grads(cfg, params, tok, lab) -> tuple[float, dict]:
    """Loss and {name: grad or None} of one backward."""
    for p in params.parameters():
        p.grad = None
    loss = loss_fn(cfg, params, torch.from_numpy(tok), torch.from_numpy(lab))
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  params.named_parameters()}


def _worst(got: dict, want: dict) -> float:
    """max over leaves of max |got - want| / max |want|; a missing port
    grad counts as zeros (it must then be zero in ``want`` too)."""
    worst = 0.0
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[name]
        g = np.zeros_like(w) if g is None else g.detach().float().numpy()
        scale = float(np.abs(w).max())
        d = float(np.abs(g - w).max())
        if scale == 0:
            assert d == 0, name
            continue
        worst = max(worst, d / scale)
    return worst



@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    cfg = smoke(arch)
    jcfg = jsmoke(arch)
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    tok = _tokens(cfg, (2, 64))
    lab = np.roll(tok, -1, axis=1)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, jnp.asarray(tok), jnp.asarray(lab))))(jp)
    want = {_path_str(p): g for p, g in
            jax.tree_util.tree_flatten_with_path(jg)[0]}
    params = params_from_reference(_np_tree(jp), cfg, "cpu")
    loss, got = _port_grads(cfg, params, tok, lab)
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    worst = _worst(got, want)
    print(f"{arch}: largest per-leaf gradient error {worst:.3g}")
    assert worst <= GRAD_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_block_remat_gradients_bit_identical(arch):
    grads = []
    for remat in ("block", "none"):
        cfg = dataclasses.replace(smoke(arch), remat=remat)
        params = init_train_state(cfg, OptConfig(), seed=3, device="cpu")[0]
        tok = _tokens(cfg, (2, 32), seed=4)
        grads.append(_port_grads(cfg, params, tok, np.roll(tok, -1, 1)))
    (l0, g0), (l1, g1) = grads
    assert l0 == l1
    for name in g0:
        assert (g0[name] is None) == (g1[name] is None), name
        if g0[name] is not None:
            assert torch.equal(g0[name], g1[name]), name
