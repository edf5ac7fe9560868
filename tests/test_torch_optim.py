"""The port's optimizer against the JAX package's, on the CPU.

The five optimizer cases of ``tests/test_optim_ckpt.py`` run on the port
as they stand there.  Against ``repro.optim``: ``schedule`` at steps
0-120 (rel 1e-6: XLA's and torch's ``cos`` may differ in the last bit);
``_quant``/``_dequant`` bit for bit (absolute value, max, divide and
round-half-to-even are correctly rounded in both); ``init_opt_state``'s
tree, leaf names, shapes and dtypes exactly; five ``apply_updates`` steps
fed the same gradients with float32 and int8 moments and with
``grad_quant_bits`` 8: parameters, float32 moments and the error
feedback within 1e-6 of the largest magnitude of their tree (the global
norm sums in another order, ~1e-7 apart, so the clip factor, and ``b **
step`` may differ in the last bits; a value near zero carries that error
against its tree's scale), an int8
moment's block scales within 4e-6 relative, and its ``q`` equal except
where the reference's float32 value lies within one ulp of a rounding
boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.optim.adamw as jadamw
from repro.optim import OptConfig as JOptConfig
from repro.optim import apply_updates as japply
from repro.optim import init_opt_state as jinit
from repro.optim import schedule as jschedule
from repro_torch.checkpoint.manager import _flatten
from repro_torch.optim import (OptConfig, apply_updates, init_opt_state,
                               quantize_with_feedback, schedule)
from repro_torch.optim.adamw import _dequant, _quant, tree_map

REL = 1e-6
# an int8 moment's block scale: the clip factor's last-bit difference
# enters v squared and compounds through each step's requantization
REL_SCALE = 4e-6


def close_tree(got, want):
    """Each leaf within REL x the largest |want| of its tree: the clip
    factor's last bits scale a whole step alike, and a leaf near zero (a
    parameter crossing it, a scalar moment whose steps cancel) carries
    that error against the tree's scale, not its own."""
    want = [np.asarray(w) for w in want]
    atol = REL * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_optim_ckpt.py), on the port
# ---------------------------------------------------------------------------

def _quadratic_trajectory(moment_dtype, steps=60):
    cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                    total_steps=steps, moment_dtype=moment_dtype)
    params = {"w": torch.tensor([3.0, -2.0, 1.5], requires_grad=True)}
    state = init_opt_state(params, cfg)
    target = torch.tensor([1.0, 1.0, 1.0])
    losses = []
    for _ in range(steps):
        params["w"].grad = None
        loss = torch.sum((params["w"] - target) ** 2)
        loss.backward()
        params, state, _ = apply_updates(params, {"w": params["w"].grad},
                                         state, cfg)
        losses.append(float(loss.detach()))
    return losses, params


def test_adamw_converges():
    losses, _ = _quadratic_trajectory("float32")
    assert losses[-1] < 1e-2 * losses[0]


def test_int8_moments_track_fp32():
    l32, p32 = _quadratic_trajectory("float32")
    l8, p8 = _quadratic_trajectory("int8")
    assert l8[-1] < 1e-1 * l8[0]
    np.testing.assert_allclose(p8["w"].detach().numpy(),
                               p32["w"].detach().numpy(), atol=0.15)


@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=1,
                max_size=300))
@settings(max_examples=20)
def test_blockwise_quant_bounded_error(vals):
    x = torch.tensor(np.asarray(vals, np.float32).reshape(1, -1))
    q, s = _quant(x)
    back = _dequant(q, s, x.shape)
    # error bounded by half a quantization step per block
    step = float(s.max())
    assert float((back - x).abs().max()) <= step * 0.51 + 1e-6


def test_grad_quant_error_feedback_unbiased():
    """Error feedback: accumulated quantized grads converge to true sum."""
    g = {"w": torch.tensor(np.random.default_rng(0)
                           .normal(size=512).astype(np.float32))}
    err = {"w": torch.zeros(512)}
    acc = torch.zeros(512)
    for _ in range(50):
        dq, err = quantize_with_feedback(g, err, 8)
        acc = acc + dq["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g["w"].numpy(),
                               atol=0.02)


def test_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    step = lambda s: torch.tensor(s, dtype=torch.int32)  # noqa: E731
    assert float(schedule(cfg, step(5))) == pytest.approx(0.5)
    assert float(schedule(cfg, step(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(schedule(cfg, step(100))) == pytest.approx(0.1, rel=1e-2)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_kw", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(),
    dict(lr=3e-4, warmup_steps=2, total_steps=12),
    dict(lr=2e-3, warmup_steps=0, total_steps=50, min_lr_frac=0.0),
], ids=["shape", "defaults", "launcher", "no_warmup"])
def test_schedule_matches_reference(cfg_kw):
    cfg, jcfg = OptConfig(**cfg_kw), JOptConfig(**cfg_kw)
    for s in range(121):
        got = float(schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        want = float(jschedule(jcfg, jnp.int32(s)))
        assert got == pytest.approx(want, rel=REL, abs=1e-30), s


@pytest.mark.parametrize("shape", [(), (7,), (3, 300), (2, 4, 520),
                                   (2, 256), (1, 1)],
                         ids=["0d", "1d", "last300", "stacked3d", "whole",
                              "one"])
def test_quant_dequant_bit_identical(shape):
    rng = np.random.default_rng(len(shape) * 1000 + sum(shape))
    x = np.asarray(rng.standard_normal(shape) * np.exp(
        rng.uniform(-8, 3, shape)), np.float32)
    if x.size > 3:
        x.reshape(-1)[:3] = (0.0, -0.0, 1e-30)
    q, s = _quant(torch.from_numpy(x.copy()))
    jq, js = jadamw._quant(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    back = _dequant(q, s, shape)
    jback = jadamw._dequant(jq, js, shape)
    assert tuple(back.shape) == shape
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  np.asarray(jback).view(np.uint32))


def _params_np():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(3, 300), "s": f(2, 4, 520), "b": f(7),
            "c": np.float32(0.5), "blocks": [{"x": f(5, 16)},
                                             {"x": f(2, 3)}]}


def _paths(tree):
    return [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in _flatten(tree)]


def _jpaths(tree):
    from repro.checkpoint.manager import _path_str
    return [(_path_str(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("moment,bits", [("float32", 0), ("int8", 0),
                                         ("float32", 8), ("int8", 8)])
def test_init_opt_state_matches_reference_tree(moment, bits):
    p = _params_np()
    state = init_opt_state(tree_map(torch.tensor, p),
                           OptConfig(moment_dtype=moment,
                                     grad_quant_bits=bits))
    jstate = jinit(jax.tree.map(jnp.asarray, p),
                   JOptConfig(moment_dtype=moment, grad_quant_bits=bits))
    assert _paths(state) == _jpaths(jstate)
    for (_, x), y in zip(_flatten(state), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _near_boundary(val: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Where ``val / max(scale, 1e-20)`` (the reference's float32 value
    before rounding, blocked as ``_quant`` blocks it) lies within one ulp
    of a half-integer."""
    x = np.asarray(val, np.float32)
    if x.ndim == 0:
        x = x[None]
    *lead, last = x.shape
    pad = (-last) % 256
    xb = np.pad(x, [(0, 0)] * len(lead) + [(0, pad)]).reshape(
        *lead, (last + pad) // 256, 256)
    r = xb / np.maximum(np.asarray(scale), np.float32(1e-20))
    return np.abs(np.abs(r) - np.floor(np.abs(r)) - 0.5) <= np.spacing(
        np.abs(r).astype(np.float32))


@pytest.mark.parametrize("moment,bits", [("float32", 0), ("int8", 0),
                                         ("float32", 8), ("int8", 8)])
def test_apply_updates_matches_reference(moment, bits, monkeypatch):
    """Five steps fed the same gradients (norms on both sides of the clip
    threshold); the port works in place on ``nn.Parameter`` leaves."""
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=5,
                  moment_dtype=moment, grad_quant_bits=bits)
    p = _params_np()
    tree = tree_map(lambda a: torch.nn.Parameter(torch.tensor(a)), p)
    ids = [id(x) for _, x in _flatten(tree)]
    state = init_opt_state(tree, OptConfig(**cfg_kw))
    jp = jax.tree.map(jnp.asarray, p)
    jstate = jinit(jp, JOptConfig(**cfg_kw))
    quantized = []
    orig_set = jadamw._moment_set
    monkeypatch.setattr(jadamw, "_moment_set", lambda val, dt: (
        quantized.append(np.asarray(val)), orig_set(val, dt))[1])
    rng = np.random.default_rng(11)
    explained = 0
    for step in range(5):
        scale = (0.01, 0.5, 0.003, 2.0, 0.02)[step]   # clip on steps 1, 3
        g = jax.tree.map(lambda a: np.asarray(
            rng.standard_normal(np.shape(a)) * scale, np.float32), p)
        quantized.clear()
        tree, state, met = apply_updates(tree, tree_map(torch.tensor, g),
                                         state, OptConfig(**cfg_kw))
        jp, jstate, jmet = japply(jp, jax.tree.map(jnp.asarray, g), jstate,
                                  JOptConfig(**cfg_kw))
        assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=REL)
        assert float(met["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=REL)
        assert [id(x) for _, x in _flatten(tree)] == ids
        close_tree([x for _, x in _flatten(tree)], jax.tree.leaves(jp))
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        if bits:
            close_tree([x for _, x in _flatten(state["err"])],
                       jax.tree.leaves(jstate["err"]))
        # the quantized values, in the reference's call order: m then v
        # for each leaf in tree order
        jm = jax.tree.leaves(jstate["m"])
        jv = jax.tree.leaves(jstate["v"])
        ours = [x for _, x in _flatten(state["m"])], \
            [x for _, x in _flatten(state["v"])]
        if moment == "float32":
            close_tree(ours[0], jm)
            close_tree(ours[1], jv)
            continue
        # int8: (q, s) pairs; a q may differ only at a rounding boundary
        pairs = list(zip(ours[0][0::2], ours[0][1::2], jm[0::2], jm[1::2],
                         quantized[0::2])) + \
            list(zip(ours[1][0::2], ours[1][1::2], jv[0::2], jv[1::2],
                     quantized[1::2]))
        for q, s, jq, js, val in pairs:
            np.testing.assert_allclose(s.numpy(), np.asarray(js),
                                       rtol=REL_SCALE, atol=0)
            diff = q.numpy() != np.asarray(jq)
            near = _near_boundary(val, np.asarray(js))
            assert not (diff & ~near).any()
            assert (np.abs(q.numpy().astype(int) -
                           np.asarray(jq).astype(int)) <= 1).all()
            explained += int(diff.sum())
    if moment == "int8":
        print(f"int8 q entries off by one at a rounding boundary: "
              f"{explained}")


def test_int8_second_moment_underflow_as_in_reference():
    """A fault both packages share (ROADMAP Queue 3): in a block whose
    gradients span more than ~16x, the stored int8 ``v`` of the small
    entries rounds to 0 while their ``m`` does not, so on the next step
    whose gradient there is small Adam divides by ``eps``: a step of ~1e6
    x lr.  The port moves the parameter exactly as far."""
    g = np.zeros((1, 256), np.float32)
    g[0, 0], g[0, 1] = 1.0, 0.02
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10, weight_decay=0.0,
              moment_dtype="int8")
    params = {"w": torch.zeros(1, 256)}
    jp = {"w": jnp.zeros((1, 256), jnp.float32)}
    state = init_opt_state(params, OptConfig(**kw))
    jstate = jinit(jp, JOptConfig(**kw))
    for grad in (g, np.zeros_like(g)):
        apply_updates(params, {"w": torch.from_numpy(grad)}, state,
                      OptConfig(**kw))
        jp, jstate, _ = japply(jp, {"w": jnp.asarray(grad)}, jstate,
                               JOptConfig(**kw))
    assert int(jstate["v"]["w"]["q"][0, 0, 1]) == 0
    assert int(jstate["m"]["w"]["q"][0, 0, 1]) != 0
    w, jw = params["w"].numpy(), np.asarray(jp["w"])
    close_tree([params["w"]], [jw])
    assert abs(jw[0, 0]) < 3e-3                    # |delta| ~ 1 a step
    assert abs(jw[0, 1]) > 1e2 and abs(w[0, 1]) > 1e2   # m / eps
