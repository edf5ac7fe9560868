"""The port's mesh path of LM training against the JAX package.

``tests/test_distributed.py``'s script, run on the reference in one
subprocess with 8 host devices (started by the module's first fixture;
the in-process cases run meanwhile), against the port on one CPU device
whose ``ShardMesh((2, 2, 2), ("pod", "data", "model"))`` holds every
region: the parameter specs leaf for leaf, the compressed psum bit for
bit, the manual MoE dispatch (against the grouped path, then against the
reference's manual path on the same weights), four meshed train steps,
the elastic reshard, ``shard_batch``'s layout, ``Trainer(mesh=)`` and the
training CLI on a mesh.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.models.moe as moe_mod
from repro_torch.configs import smoke
from repro_torch.data import ZipfTokenStream, shard_batch
from repro_torch.launch import Placement, make_host_mesh
from repro_torch.launch.elastic import (_sanitize, reshard_opt_state,
                                       reshard_params)
from repro_torch.launch.sharding import (activate, get_mesh, map_tree,
                                         named_shardings, param_specs)
from repro_torch.models import init_params, loss_fn
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import OptConfig, psum_compressed
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train import Trainer, TrainerConfig, make_train_step

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
# the reference's gates (tests/test_distributed.py)
MOE_LOSS_TOL, MOE_GRAD_TOL = 2e-4, 5e-3
# the grouped MoE's tolerance against the reference (test_torch_lm_layers)
MOE_ATOL, MOE_RTOL = 1e-5, 1e-4
TRAIN_LOSS_TOL = 1e-4

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import numpy as np
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import smoke
from repro.data import ZipfTokenStream, shard_batch
from repro.launch import compat
from repro.launch.elastic import reshard_params
from repro.launch.sharding import _path_str, param_specs
from repro.models import init_params, loss_fn
from repro.models import moe as jmoe
from repro.optim import OptConfig, psum_compressed
from repro.optim.adamw import init_opt_state
from repro.train.step import make_train_step

assert len(jax.devices()) == 8
out, arrays = {{}}, {{}}
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
key = jax.random.PRNGKey(0)

def js(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arrays[prefix + _path_str(path)] = np.asarray(leaf)

def spec_tree(specs):
    return {{_path_str(p): js(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda s: isinstance(s, P))[0]}}

# parameter specs of the smoke trees
with compat.activate(mesh):
    for arch in ("qwen3-4b", "kimi-k2-1t-a32b"):
        shapes = jax.eval_shape(lambda k: init_params(smoke(arch), k), key)
        out["specs/" + arch] = spec_tree(param_specs(shapes))

# meshed training (tests/test_distributed.py's loop)
cfg = smoke("qwen3-4b")
opt_cfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
with compat.activate(mesh):
    params = init_params(cfg, key)
    flat(params, "train_init/")
    specs = param_specs(params)
    p_sh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda s: isinstance(s, P))
    params = jax.tree.map(lambda x, s: jax.device_put(x, s), params, p_sh)
    opt_state = init_opt_state(params, opt_cfg)
    step_fn = jax.jit(make_train_step(cfg, opt_cfg))
    stream = ZipfTokenStream(cfg.vocab_size, 32, seed=1)
    losses = []
    for i in range(4):
        batch = shard_batch(stream.batch(i, 8), mesh, microbatches=2)
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    out["batch_spec"] = js(batch["tokens"].sharding.spec)
try:
    shard_batch(stream.batch(0, 6), mesh, microbatches=2)
    out["indivisible"] = None
except ValueError as e:
    out["indivisible"] = type(e).__name__

# compressed cross-pod psum: the reference's shard_map over "pod"
fm = compat.shard_map(lambda t: psum_compressed(t, "pod"), mesh=mesh,
                      in_specs=(P(("pod",)),), out_specs=P(("pod",)),
                      check=True)
rng = np.random.default_rng(0)
cases = {{"small": np.arange(64, dtype=np.float32).reshape(8, 8) / 7.0,
         "rows": (rng.standard_normal((6, 700)) * 3).astype(np.float32),
         "blocks": rng.standard_normal((4, 5, 300)).astype(np.float32)}}
for name, g in cases.items():
    arrays["psum_in/" + name] = g
    arrays["psum_out/" + name] = np.asarray(fm(jax.device_put(
        jnp.asarray(g), NamedSharding(mesh, P(("pod",))))))

# the manual MoE dispatch (custom_vjp shard_map) on kimi's smoke config
kcfg0 = smoke("kimi-k2-1t-a32b")
ktok = jax.random.randint(key, (4, 32), 0, kcfg0.vocab_size)
arrays["moe_tokens"] = np.asarray(ktok)
kcfg4 = dataclasses.replace(kcfg0, moe_groups=4)
with compat.activate(mesh):
    kp = init_params(kcfg0, key)
    flat(kp, "moe_params/")
    l, gr = jax.jit(jax.value_and_grad(
        lambda pp: loss_fn(kcfg4, pp, ktok, ktok)))(kp)
    out["moe_loss"] = float(l)
    flat(gr, "moe_grads/")
    # the layer alone: output and gradients of <y, ct>
    p0 = jmoe.MoEParams(*(kp["blocks"][0]["ffn"][n][0]
                          for n in jmoe.MoEParams._fields))
    x = jnp.asarray(rng.standard_normal((4, 32, kcfg0.d_model)),
                    jnp.float32)
    ct = jnp.asarray(rng.standard_normal((4, 32, kcfg0.d_model)),
                     jnp.float32)
    arrays["layer/x"], arrays["layer/ct"] = np.asarray(x), np.asarray(ct)
    def f(pp, xx):
        y = jmoe.moe_ffn(pp, kcfg4, xx, kcfg4.act)
        return jnp.sum(y * ct), y
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p0, x)
    arrays["layer/y"], arrays["layer/dx"] = np.asarray(y), np.asarray(gx)
    for n, g in zip(jmoe.MoEParams._fields, gp):
        arrays["layer/d_" + n] = np.asarray(g)

# elastic: reshard onto a smaller mesh
small = compat.make_mesh((2, 2), ("data", "model"))
re = reshard_params(jax.tree.map(np.asarray, params), small)
out["reshard_specs"] = {{_path_str(p): js(l.sharding.spec) for p, l in
                        jax.tree_util.tree_flatten_with_path(re)[0]}}
np.savez({npz!r}, **arrays)
print("RESULT::" + json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_when_parallel():
    """In a parallel run (pytest-xdist workers share the cores) this
    module's torch ops take one thread each."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference_proc(tmp_path_factory):
    """The reference's script, started in a subprocess of 8 host devices
    at the module's first fixture; ``reference`` collects it."""
    npz = str(tmp_path_factory.mktemp("distributed") / "reference.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("PYTHONWARNINGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT.format(src=os.path.abspath(SRC),
                                             npz=npz)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, npz
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_proc):
    proc, npz = reference_proc
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("RESULT::")][-1]
    return json.loads(line[len("RESULT::"):]), dict(np.load(npz))


def mesh3():
    return make_host_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")


def _js(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree) -> dict:
    out = {}
    map_tree(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def _tree_from(arrays, prefix, cfg):
    """The reference tree saved under ``prefix`` as the port's params."""
    shape = init_params(cfg, device="meta").tree()
    return params_from_reference(
        map_tree(lambda path, _: arrays[prefix + path], shape), cfg, "cpu")


def _grads(cfg, params, tok, lab):
    for p in params.parameters():
        p.grad = None
    loss = loss_fn(cfg, params, tok, lab)
    loss.backward()
    return float(loss.detach()), {
        n: (p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in params.named_parameters()}


@pytest.fixture
def manual_calls(monkeypatch):
    calls = []
    orig = moe_mod._grouped_manual

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(moe_mod, "_grouped_manual", counted)
    return calls


# ---------------------------------------------------------------------------
# in-process: the port against itself and the reference's rules
# ---------------------------------------------------------------------------

def test_mesh_context_nests_and_restores(reference_proc):
    m3, m2 = mesh3(), make_host_mesh(device="cpu")
    assert get_mesh() is None
    with activate(m3):
        with activate(m2):
            assert get_mesh() is m2
        assert get_mesh() is m3
    assert get_mesh() is None


@pytest.mark.parametrize("groups", [4, 1])
def test_manual_moe_matches_grouped_path(groups, manual_calls):
    """The reference's gate (loss 2e-4, gradient 5e-3) between the manual
    dispatch at ``moe_groups`` 4 under the mesh and the same weights with
    no mesh at ``groups`` (the grouped path at 4, the global sort at 1)."""
    cfg0 = smoke("kimi-k2-1t-a32b")
    params = init_params(cfg0, 0, "cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg0.vocab_size, (4, 32)).astype(np.int32))
    with activate(mesh3()):
        lm, gm = _grads(dataclasses.replace(cfg0, moe_groups=4), params,
                        tok, tok)
    assert len(manual_calls) == 2 * cfg0.n_layers   # forward + recompute
    lg, gg = _grads(dataclasses.replace(cfg0, moe_groups=groups), params,
                    tok, tok)
    assert len(manual_calls) == 2 * cfg0.n_layers
    assert abs(lm - lg) < MOE_LOSS_TOL
    assert max(float((gm[n] - gg[n]).abs().max()) for n in gm) < MOE_GRAD_TOL


def test_manual_branch_conditions(manual_calls):
    """Taken only under a mesh with dp axes whose model size divides the
    experts, and only for ``moe_groups > 1``."""
    cfg = dataclasses.replace(smoke("kimi-k2-1t-a32b"), moe_groups=4)
    p = init_params(cfg, 0, "cpu")
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(0))
    ffn = moe_mod.MoEParams(*(getattr(p.blocks[0].ffn, n)[0]
                              for n in moe_mod.MoEParams._fields))
    meshes = {"none": None,
              "model only": make_host_mesh((2,), ("model",), device="cpu"),
              "3 model regions": make_host_mesh((2, 3), ("data", "model"),
                                                device="cpu"),
              "data x model": make_host_mesh(device="cpu")}
    got = {}
    for name, m in meshes.items():
        before = len(manual_calls)
        with activate(m) if m is not None else contextlib.nullcontext():
            y = moe_mod.moe_ffn(ffn, cfg, x)
        got[name] = len(manual_calls) - before
        assert y.shape == x.shape
    assert got == {"none": 0, "model only": 0, "3 model regions": 0,
                   "data x model": 1}
    with activate(mesh3()), pytest.raises(ValueError, match="dp regions"):
        moe_mod.moe_ffn(ffn, dataclasses.replace(cfg, moe_groups=2), x)


def test_psum_compressed_within_one_step_of_exact():
    """tests/test_distributed.py's bound: one int8 step per summand."""
    g = torch.arange(64, dtype=torch.float32).reshape(8, 8) / 7.0
    got = psum_compressed({"w": g.view(2, 4, 8)}, "pod", mesh3())["w"]
    exact = g[:4] + g[4:]
    assert got.shape == (2, 4, 8) and torch.equal(got[0], got[1])
    assert float((got[0] - exact).abs().max()) < 0.15
    with pytest.raises(ValueError, match="regions"):
        psum_compressed({"w": g}, "pod", mesh3())


def test_reshard_params_preserves_values_and_places():
    cfg = smoke("qwen3-4b")
    opt = OptConfig()
    params = init_params(cfg, 0, "cpu")
    state = init_opt_state(params, opt)
    small = make_host_mesh(device="cpu")
    re = reshard_params(params, small)
    assert type(re) is type(params)
    for (n, a), (_, b) in zip(params.named_parameters(),
                              re.named_parameters()):
        assert torch.equal(a, b) and b.data_ptr() == a.data_ptr(), n
        assert b.placement.mesh == small
        assert not hasattr(a, "placement")
    with activate(small):
        want = param_specs(params)
    for path, spec in _flat(want).items():
        leaf = _flat(re)[path]
        assert leaf.placement.spec == _sanitize(spec, leaf.shape, small)
    st = reshard_opt_state(state, re)
    for m, p in zip(_flat(st["m"]).values(), _flat(re).values()):
        assert m.placement == p.placement
    assert st["step"] is state["step"]
    q = init_opt_state(params, OptConfig(moment_dtype="int8"))
    assert reshard_opt_state(q, re)["m"] is q["m"]
    back = reshard_params(re, mesh3())
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(),
                                                 back.parameters()))


def test_trainer_with_mesh_reaches_manual_dispatch(tmp_path, manual_calls):
    cfg = dataclasses.replace(smoke("kimi-k2-1t-a32b"), moe_groups=4)
    tc = TrainerConfig(steps=3, global_batch=8, microbatches=2, seq_len=16,
                       ckpt_every=3, ckpt_dir=str(tmp_path), seed=3)
    mesh = mesh3()
    seen = []
    orig = Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=1),
                   tc, mesh=mesh, log_fn=lambda s: None)
    step = orig.train_step

    def spy(params, state, batch):
        seen.append(batch["tokens"].placement)
        return step(params, state, batch)
    orig.train_step = spy
    with activate(mesh):
        res = orig.run()
    assert orig.device == mesh.device
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert manual_calls
    assert seen[0] == Placement(mesh, (None, ("pod", "data"), None))
    # resumes from its checkpoint on the mesh; as in the reference
    # (src/repro/train/trainer.py:84-85) the Trainer only shards the
    # batch, so without ``activate`` the model takes the grouped path
    n = len(manual_calls)
    again = Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=1),
                    dataclasses.replace(tc, steps=4), mesh=mesh,
                    log_fn=lambda s: None).run()
    assert len(again["losses"]) == 1 and len(manual_calls) == n


def test_train_cli_mesh_host2x2(tmp_path, capsys):
    from repro_torch.launch.train import main
    res = main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                "--mesh", "host2x2", "--steps", "3", "--batch", "4",
                "--seq", "16", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert "[train] done; final loss" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# against the reference's subprocess
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "kimi-k2-1t-a32b"])
def test_param_specs_match_reference(reference, arch):
    meta, _ = reference
    with activate(mesh3()):
        got = {k: _js(v) for k, v in
               _flat(param_specs(init_params(smoke(arch),
                                             device="meta"))).items()}
    assert got == meta["specs/" + arch]
    places = named_shardings(mesh3(), param_specs(
        init_params(smoke(arch), device="meta")))
    assert all(isinstance(p, Placement) for p in _flat(places).values())


@pytest.mark.parametrize("case", ["small", "rows", "blocks"])
def test_psum_compressed_matches_shard_map(reference, case):
    """Bit for bit with the reference's ``shard_map`` over "pod": the
    whole array's halves are the two pod regions."""
    _, arrays = reference
    g = torch.from_numpy(arrays["psum_in/" + case])
    got = psum_compressed([g.view(2, g.shape[0] // 2, *g.shape[1:])],
                          "pod", mesh3())[0]
    want = arrays["psum_out/" + case]
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


def test_manual_moe_layer_matches_reference(reference):
    """The manual dispatch alone, on the reference's weights and input:
    output and the gradients of <y, ct> at the grouped MoE's tolerance."""
    _, arrays = reference
    cfg = dataclasses.replace(smoke("kimi-k2-1t-a32b"), moe_groups=4)
    params = _tree_from(arrays, "moe_params/", cfg)
    ffn = moe_mod.MoEParams(*(getattr(params.blocks[0].ffn, n)[0].detach()
                              .clone().requires_grad_()
                              for n in moe_mod.MoEParams._fields))
    x = torch.from_numpy(arrays["layer/x"]).requires_grad_()
    with activate(mesh3()):
        y = moe_mod.moe_ffn(ffn, cfg, x, cfg.act)
    (y * torch.from_numpy(arrays["layer/ct"])).sum().backward()
    kw = dict(atol=MOE_ATOL, rtol=MOE_RTOL)
    np.testing.assert_allclose(y.detach().numpy(), arrays["layer/y"], **kw)
    np.testing.assert_allclose(x.grad.numpy(), arrays["layer/dx"], **kw)
    for n, p in zip(moe_mod.MoEParams._fields, ffn):
        np.testing.assert_allclose(p.grad.numpy(), arrays["layer/d_" + n],
                                   err_msg=n, **kw)


def test_manual_moe_model_matches_reference(reference, manual_calls):
    """kimi's smoke model at ``moe_groups`` 4 under the mesh, on the
    reference's weights: loss and every gradient against the reference's
    manual path."""
    meta, arrays = reference
    cfg = dataclasses.replace(smoke("kimi-k2-1t-a32b"), moe_groups=4)
    params = _tree_from(arrays, "moe_params/", cfg)
    tok = torch.from_numpy(arrays["moe_tokens"]).to(torch.int32)
    with activate(mesh3()):
        loss, grads = _grads(cfg, params, tok, tok)
    assert manual_calls
    assert abs(loss - meta["moe_loss"]) <= MOE_ATOL + MOE_RTOL * abs(
        meta["moe_loss"])
    for name, g in grads.items():
        np.testing.assert_allclose(
            g.numpy(), arrays["moe_grads/" + name.replace(".", "/")],
            atol=MOE_ATOL, rtol=MOE_RTOL, err_msg=name)


def test_meshed_train_steps_match_reference(reference):
    """tests/test_distributed.py's four steps on the reference's
    ``init_params(PRNGKey(0))``, the batches through ``shard_batch`` on
    the mesh: losses within 1e-4 of the reference's sharded run."""
    meta, arrays = reference
    cfg = smoke("qwen3-4b")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    mesh = mesh3()
    params = _tree_from(arrays, "train_init/", cfg)
    state = init_opt_state(params, opt)
    step = make_train_step(cfg, opt)
    stream = ZipfTokenStream(cfg.vocab_size, 32, seed=1)
    losses = []
    with activate(mesh):
        for i in range(4):
            batch = shard_batch(stream.batch(i, 8), mesh, microbatches=2)
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, meta["losses"], rtol=0,
                               atol=TRAIN_LOSS_TOL)
    assert losses[-1] < losses[0]


def test_shard_batch_layout_and_placement(reference):
    meta, _ = reference
    mesh = mesh3()
    b = ZipfTokenStream(vocab_size=100, seq_len=16).batch(0, 8)
    out = shard_batch(b, mesh, microbatches=2)
    assert out["tokens"].shape == (2, 4, 16)
    assert torch.equal(out["tokens"].reshape(8, 16),
                       torch.from_numpy(b["tokens"]))
    assert out["tokens"].device == mesh.device
    assert _js(out["labels"].placement.spec) == meta["batch_spec"]
    assert out["tokens"].placement.mesh is mesh
    assert meta["indivisible"] == "ValueError"
    with pytest.raises(ValueError, match="dp regions"):
        shard_batch(ZipfTokenStream(100, 16).batch(0, 6), mesh, 2)


def test_reshard_specs_match_reference(reference):
    meta, _ = reference
    re = reshard_params(init_params(smoke("qwen3-4b"), 0, "cpu"),
                        make_host_mesh(device="cpu"))
    got = {k: _js(v.placement.spec) for k, v in _flat(re).items()}
    want = meta["reshard_specs"]
    assert set(got) == set(want)
    # an array's sharding spells a one-axis tuple as the axis and drops
    # trailing Nones
    for k, spec in want.items():
        g = [e[0] if isinstance(e, list) and len(e) == 1 else e
             for e in got[k]]
        assert g[:len(spec)] == spec and not any(g[len(spec):]), k


@pytest.mark.parametrize("moment,bits", [("float32", 0), ("int8", 8)])
def test_update_slices_the_rows_of_a_one_repeat_leaf(moment, bits,
                                                     monkeypatch):
    """A stacked leaf of one repeat (6i's jamba cut: ``(1, 16, 4096,
    14336)`` experts) is updated a slice of its rows at a time, not whole:
    with slices of 600 elements every parameter, moment and residual
    equals the one-slice update bit for bit (the clip is 1 in both)."""
    import repro_torch.optim.adamw as adamw
    gen = torch.Generator().manual_seed(5)
    shapes = {"e": (1, 8, 300), "s": (2, 3, 520), "b": (7,)}
    opt = OptConfig(moment_dtype=moment, grad_quant_bits=bits,
                    grad_clip=1e9, warmup_steps=1)

    def run(slice_elems):
        monkeypatch.setattr(adamw, "SLICE_ELEMS", slice_elems)
        g = torch.Generator().manual_seed(5)
        params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
        state = init_opt_state(params, opt)
        for _ in range(3):
            grads = {k: torch.randn(s, generator=gen)
                     for k, s in shapes.items()}
            params, state, _ = adamw.apply_updates(params, grads, state, opt)
        return params, state

    gen.manual_seed(5)
    whole = run(1 << 30)
    gen.manual_seed(5)
    used = []
    orig = adamw._slices
    monkeypatch.setattr(adamw, "_slices", lambda x: used.append(
        (tuple(x.shape), len(orig(x)))) or orig(x))
    sliced = run(600)
    # the (1, 8, 300) leaf as 8 rows of 300, two rows a slice
    assert ((8, 300), 4) in used and not any(n == 1 and len(s) > 2
                                             for s, n in used)
    for (a,), (b,) in zip(adamw.walk(whole), adamw.walk(sliced)):
        assert torch.equal(a, b)
