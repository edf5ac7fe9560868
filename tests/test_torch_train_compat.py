"""LM training across the packages, on the CPU.

One ``make_train_step`` of 2 microbatches against the reference's: loss
and ``grad_norm`` within 1e-5 relative (float32 sums in another order;
``grad_norm`` also sums its leaves' squares in another order), the
averaged gradients within 1e-4 of each leaf's largest |g| (as
``tests/test_torch_train.py``), and the parameters compared only after
the port's ``apply_updates`` is fed the reference's gradients, within
1e-6 of the largest parameter: Adam's first step is ~``sign(g)``, so a
gradient 1e-6 off can move a near-zero element 2 x lr.

The SSD scan at mamba2-780m's 128-token chunk: the reference's gradient
is NaN (ROADMAP Queue 3), the port's within 1e-4 of each leaf's largest
|g| of the reference's gradient at chunk 16 (the same function, chunked
finer), its output within 1e-5 of its scale.

Training checkpoints cross between the packages byte for byte: a run of
the reference's ``Trainer`` stopped by ``fail_at_step`` resumes in the
port's, and a port run resumes in the reference's; every restored leaf
(bf16 parameters, int8 moment dicts, the error feedback, the step) equals
the saved one byte for byte, and both runs finish.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.step as jstep_mod
from repro.checkpoint.manager import _path_str
from repro.checkpoint.manager import load_arrays as jload_arrays
from repro.configs import smoke as jsmoke
from repro.models.transformer import init_params as jinit_params
from repro.optim import OptConfig as JOptConfig
from repro.optim import init_opt_state as jinit_opt
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint.manager import _flatten, load_arrays
from repro_torch.configs import smoke
from repro_torch.data import shard_batch
from repro_torch.models import params_from_reference
from repro_torch.optim import OptConfig, apply_updates, init_opt_state
from repro_torch.optim.adamw import tree_map
from repro_torch.train import Trainer, TrainerConfig, make_train_step
import repro_torch.train.step as step_mod

GRAD_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _worst(got: dict, want: dict) -> float:
    worst = 0.0
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[name].detach().float().numpy()
        scale = float(np.abs(w).max())
        d = float(np.abs(g - w).max())
        if scale == 0:
            assert d == 0, name
            continue
        worst = max(worst, d / scale)
    return worst


def test_train_step_matches_reference(monkeypatch):
    arch = "qwen3-4b"
    cfg, jcfg = smoke(arch), jsmoke(arch)
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jp = jinit_params(jcfg, jax.random.PRNGKey(2))
    p0 = _np_tree(jp)
    tok = _tokens(cfg, (2, 2, 48), seed=5)
    lab = np.roll(tok, -1, axis=2)
    seen = {}
    orig = jstep_mod.apply_updates

    def capture(p, g, s, c):     # the gradients the jitted step applies
        jax.debug.callback(lambda g: seen.setdefault("g", _np_tree(g)), g)
        return orig(p, g, s, c)
    monkeypatch.setattr(jstep_mod, "apply_updates", capture)
    jstep = jax.jit(jstep_mod.make_train_step(jcfg, JOptConfig(**opt_kw)))
    jnew, _, jmet = jstep(jp, jinit_opt(jp, JOptConfig(**opt_kw)),
                          {"tokens": jnp.asarray(tok),
                           "labels": jnp.asarray(lab)})

    params = params_from_reference(p0, cfg, "cpu")
    opt = OptConfig(**opt_kw)
    state = init_opt_state(params, opt)
    ours = {}
    port_apply = step_mod.apply_updates
    monkeypatch.setattr(step_mod, "apply_updates", lambda p, g, s, c: (
        ours.setdefault("g", tree_map(torch.clone, g)),
        port_apply(p, g, s, c))[1])
    batch = shard_batch({"tokens": tok.reshape(4, 48),
                         "labels": lab.reshape(4, 48)}, None, 2,
                        device="cpu")
    _, _, met = make_train_step(cfg, opt)(params, state, batch)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                               rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-5)
    assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    # the step's averaged gradients, leaf by leaf
    got = {p: g for p, g in _flatten(ours["g"])}
    want = {_path_str(p): g for p, g in
            jax.tree_util.tree_flatten_with_path(seen["g"])[0]}
    assert _worst(got, want) <= GRAD_TOL
    # the parameters, from the reference's gradients
    fresh = params_from_reference(p0, cfg, "cpu")
    apply_updates(fresh, tree_map(torch.from_numpy, seen["g"]),
                  init_opt_state(fresh, opt), opt)
    want_p = jax.tree.leaves(jnew)
    atol = 1e-6 * max(float(np.abs(np.asarray(w)).max()) for w in want_p)
    for (_, x), w in zip(_flatten(fresh.tree()), want_p):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=atol)


def test_ssd_gradient_finite_at_the_published_chunk():
    """mamba2-780m's chunk of 128: the decay above the diagonal sums ~100
    and its ``exp`` overflows.  The reference masks it after the ``exp``
    and its gradient is NaN (ROADMAP Queue 3); the port masks before it:
    the same forward, and the gradient the reference gives at chunk 16
    (the same function, chunked finer)."""
    from repro.models.ssm import ssd_scan as jssd
    from repro_torch.models.ssm import ssd_scan
    rng = np.random.default_rng(9)
    b, s, nh, hd, n = 1, 256, 4, 8, 8
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    a_log = np.zeros(nh, np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    args = (x, dt, a_log, bm, cm)

    def jgrads(chunk):
        return jax.jit(jax.grad(lambda *a: jssd(*a, chunk)[0].sum(),
                                argnums=(0, 1, 2, 3, 4)))(
            *map(jnp.asarray, args))
    assert np.cumsum(dt[0, :128, 0])[-1] > 88.8      # exp overflows float32
    assert any(np.isnan(np.asarray(g)).any() for g in jgrads(128))
    want = jgrads(16)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, h = ssd_scan(*ts, 128)
    jy, jh = jssd(*map(jnp.asarray, args), 128)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5 * float(np.abs(jy).max()))
    y.sum().backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        assert np.isfinite(w).all() and torch.isfinite(t.grad).all()
        err = float(np.abs(t.grad.numpy() - w).max() / np.abs(w).max())
        assert err <= GRAD_TOL


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

ARCH = "mamba2-780m"
# int8 moments diverge at larger rates in both packages (ROADMAP Queue 3)
OPT_KW = dict(lr=1e-4, warmup_steps=2, total_steps=6, moment_dtype="int8",
              grad_quant_bits=8)
TC_KW = dict(steps=6, global_batch=4, microbatches=2, seq_len=32,
             ckpt_every=2, log_every=100, keep_ckpts=2)


def _cfgs():
    # bf16 parameters, so that their 16-bit patterns cross too
    return (dataclasses.replace(smoke(ARCH), dtype="bfloat16"),
            dataclasses.replace(jsmoke(ARCH), dtype="bfloat16"))


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy().tobytes()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.uint16)
    return x.tobytes()


def _saved(d, step) -> dict:
    """{path: bytes as stored} of a checkpoint, read by both packages."""
    ours, _ = load_arrays(d, step)
    ref, _ = jload_arrays(d, step)
    assert list(ours) == list(ref)
    for k in ours:
        assert _bytes(ours[k]) == _bytes(ref[k]), k
    return {k: _bytes(v) for k, v in ours.items()}


def test_reference_checkpoint_resumes_in_port():
    cfg, jcfg = _cfgs()
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError):
            JTrainer(jcfg, JOptConfig(**OPT_KW),
                     JTrainerConfig(ckpt_dir=d, **TC_KW),
                     log_fn=lambda s: None).run(fail_at_step=5)
        saved = _saved(d, 4)
        tr = Trainer(cfg, OptConfig(**OPT_KW), TrainerConfig(ckpt_dir=d,
                                                             **TC_KW),
                     log_fn=lambda s: None, device="cpu")
        restored = {}
        orig = tr.ckpt.restore_latest

        def capture(template, device=None):
            step, tree = orig(template, device)
            restored.update((p, _bytes(x)) for p, x in _flatten(tree))
            return step, tree
        tr.ckpt.restore_latest = capture
        res = tr.run()
        assert list(restored) == list(saved)
        for k in saved:
            assert restored[k] == saved[k], k
        assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
        assert res["params"].embed.tokens.dtype == torch.bfloat16
        _saved(d, 6)


def test_port_checkpoint_resumes_in_reference():
    cfg, jcfg = _cfgs()
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError):
            Trainer(cfg, OptConfig(**OPT_KW), TrainerConfig(ckpt_dir=d,
                                                            **TC_KW),
                    log_fn=lambda s: None, device="cpu").run(fail_at_step=5)
        saved = _saved(d, 4)
        tr = JTrainer(jcfg, JOptConfig(**OPT_KW),
                      JTrainerConfig(ckpt_dir=d, **TC_KW),
                      log_fn=lambda s: None)
        restored = {}
        orig = tr.ckpt.restore_latest

        def capture(template, shardings=None):
            step, tree = orig(template, shardings)
            restored.update(
                (_path_str(p), _bytes(x)) for p, x in
                jax.tree_util.tree_flatten_with_path(tree)[0])
            return step, tree
        tr.ckpt.restore_latest = capture
        res = tr.run()
        assert list(restored) == list(saved)
        for k in saved:
            assert restored[k] == saved[k], k
        assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
        _saved(d, 6)
