"""The port's dry-run and roofline against the JAX package's.

In-process: the analytic roofline (``analytic_cost``, ``model_flops_for``)
exactly, for the ten configs x four shapes on the 16x16 and 2x16x16
meshes; the sharding helpers (``_pick_spec``, ``_cache_shardings``,
``_batch_shardings``, ``_opt_shardings``) against the reference's on a
``jax.sharding.AbstractMesh`` of the same shape (no 512 devices needed);
``run_cell`` on ``meta`` for a train, a prefill and a decode cell on each
mesh, and the CLI.  In a subprocess with 4 host devices (started by the
module's first fixture): the reference compiles smoke qwen3-4b's train
and decode steps on a (2, 2) mesh, and the port's per-chip argument bytes
must equal its ``memory_analysis()``; the collective reckoning is printed
beside the reference's HLO parse, as information.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import input_specs as jinput_specs
from repro.launch import roofline as jroofline
from repro.launch.sharding import _path_str, param_specs as jparam_specs
from repro.models.transformer import init_caches as jinit_caches
from repro.models.transformer import init_params as jinit_params
from repro.optim.adamw import OptConfig as JOptConfig
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro_torch.configs import SHAPES, get_config, input_specs, list_archs
from repro_torch.configs import smoke
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.sharding import activate, map_tree, param_specs
from repro_torch.models import init_caches, init_params
from repro_torch.optim import OptConfig, init_opt_state

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESHES = {"16x16": False, "2x16x16": True}

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import numpy as np
sys.path.insert(0, {src!r})
import jax
jax.devices()
import repro.launch.dryrun as D
from repro.configs import smoke
from jax.sharding import Mesh

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
D.make_production_mesh = lambda multi_pod=False: mesh
D.get_config = smoke
out = {{}}
for shape in ("train_4k", "decode_32k"):
    rec = D.run_cell("qwen3-4b", shape, False, verbose=False)
    out[shape] = {{"memory": rec["memory"],
                  "collectives": {{k: v for k, v in rec["collectives"].items()
                                  if not k.startswith("_")}}}}
print("RESULT::" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_proc():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("PYTHONWARNINGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT.format(src=os.path.abspath(SRC))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jdryrun(reference_proc):
    """The reference's dry-run module.  It writes a 512-device
    ``XLA_FLAGS`` when imported: the backend is started first (one
    device, as this process must keep) and the variable restored."""
    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jd
    if prev is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = prev
    assert len(jax.devices()) == 1
    return jd


def _amesh(multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def _spec(s):
    """A spec (port tuple or reference PartitionSpec) as a list; a
    one-axis tuple is spelled as the axis, as ``NamedSharding`` spells
    it."""
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple)
            else e for e in s]


def _jflat(tree):
    return {_path_str(p): _spec(leaf.spec) for p, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))[0]}


def _flat(tree):
    out = {}
    map_tree(lambda path, leaf: out.__setitem__(path, _spec(leaf.spec)),
             tree)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_roofline_equals_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert list_archs() == jlist_archs()
    for shape, sp in SHAPES.items():
        assert dataclasses.asdict(sp) == dataclasses.asdict(JSHAPES[shape])
        tokens = sp.global_batch * (sp.seq_len if sp.kind != "decode"
                                    else 1)
        assert roofline.model_flops_for(cfg, sp.kind, tokens) == \
            jroofline.model_flops_for(jcfg, sp.kind, tokens)
        for n_chips in (256, 512):
            for mb in (8, 4):
                assert roofline.analytic_cost(
                    cfg, sp.kind, sp.global_batch, sp.seq_len, n_chips,
                    mb) == jroofline.analytic_cost(
                    jcfg, sp.kind, sp.global_batch, sp.seq_len, n_chips,
                    mb)
    terms = roofline.derive_terms({"flops": 1e15, "bytes accessed": 2e12},
                                  3e9, 4e9, 256, 1e17)
    assert terms.dominant == "compute"
    assert terms.compute_s == 1e15 / 989e12
    assert terms.memory_s == 2e12 / 3.35e12
    assert terms.collective_s == 4e9 / 450e9


@pytest.mark.parametrize("multi_pod", [False, True], ids=list(MESHES))
def test_pick_spec_equals_reference(jdryrun, multi_pod):
    mesh, am = make_production_mesh(multi_pod=multi_pod), _amesh(multi_pod)
    rng = np.random.default_rng(0)
    logical = ["dp", "tp", "data", "model", "pod", None]
    for _ in range(300):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice([1, 2, 3, 8, 16, 24, 32, 512, 4096]))
                      for _ in range(nd))
        prefs = [(int(rng.integers(nd)), logical[int(rng.integers(6))])
                 for _ in range(int(rng.integers(1, 4)))]
        assert _spec(dryrun._pick_spec(shape, mesh, prefs)) == \
            _spec(jdryrun._pick_spec(shape, am, prefs)), (shape, prefs)
        spec = tuple(rng.choice(list(mesh.axis_names) + [None])
                     for _ in range(nd))
        assert _spec(dryrun._sanitize(spec, shape, mesh)) == \
            _spec(jdryrun._sanitize(P(*spec), shape, am))


@pytest.mark.parametrize("multi_pod", [False, True], ids=list(MESHES))
def test_cell_shardings_equal_reference(jdryrun, multi_pod):
    """The caches', batches' and optimizer state's shardings of every
    config (float32 and int8 moments) against the reference's helpers."""
    mesh, am = make_production_mesh(multi_pod=multi_pod), _amesh(multi_pod)
    key = jax.random.PRNGKey(0)
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape, sp in SHAPES.items():
            got = dryrun._batch_shardings(input_specs(cfg, shape), mesh)
            want = jdryrun._batch_shardings(jinput_specs(jcfg, shape), am)
            assert _flat(got) == _jflat(want), (arch, shape)
        for shape in ("decode_32k", "long_500k"):
            sp = SHAPES[shape]
            caches = init_caches(cfg, sp.global_batch, sp.seq_len,
                                 cfg.n_image_tokens, device="meta")
            jc = jax.eval_shape(lambda: jinit_caches(
                jcfg, sp.global_batch, sp.seq_len, jcfg.n_image_tokens))
            got = dryrun._cache_shardings(cfg, caches, mesh)
            want = jdryrun._cache_shardings(jcfg, jc, am)
            assert [[_spec(s.spec) for s in c] for c in got] == \
                [[_spec(s.spec) for s in c] for c in want], (arch, shape)
        params = init_params(cfg, device="meta")
        with activate(mesh):
            specs = map_tree(
                lambda _, leaf, s: dryrun._sanitize(s, leaf.shape, mesh),
                params, param_specs(params))
        with jax.sharding.use_abstract_mesh(am):
            jp = jax.eval_shape(lambda k: jinit_params(jcfg, k), key)
            jspecs = jax.tree.map(
                lambda leaf, s: jdryrun._sanitize(s, leaf.shape, am),
                jp, jparam_specs(jp))
        for moments in ("float32", "int8"):
            got = dryrun._opt_shardings(init_opt_state(
                params, OptConfig(moment_dtype=moments)), specs, mesh)
            jo = jax.eval_shape(lambda: jinit_opt_state(
                jp, JOptConfig(moment_dtype=moments)))
            want = jdryrun._opt_shardings(jo, jspecs, am)
            assert _flat(got) == _jflat(want), (arch, moments)


CELLS = [("qwen3-4b", "train_4k"), ("musicgen-large", "prefill_32k"),
         ("qwen3-4b", "decode_32k")]


@pytest.mark.parametrize("multi_pod", [False, True], ids=list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_completes_on_meta(arch, shape, multi_pod):
    rec = dryrun.run_cell(arch, shape, multi_pod, verbose=False)
    cfg, sp = get_config(arch), SHAPES[shape]
    n_chips = 512 if multi_pod else 256
    assert rec["status"] == "ok" and isinstance(rec["fits_h100"], bool)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    an = roofline.analytic_cost(cfg, sp.kind, sp.global_batch, sp.seq_len,
                                n_chips)
    assert rec["roofline"]["flops_per_chip"] == an["flops_per_chip"]
    assert rec["dominant"] in ("compute", "memory", "collective")
    mem = rec["memory"]
    assert 0 < mem["argument_size_in_bytes"] <= mem["per_chip_bytes"] + \
        mem["alias_size_in_bytes"]
    assert rec["cost"]["flops"] > 0
    coll = rec["collectives"]
    assert set(coll) == {"all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute", "_counts",
                         "_top"}
    # the weights stream in over dp in every kind of step
    assert coll["all-gather"] > 0


def test_run_cell_skips_and_cli(tmp_path, capsys):
    rec = dryrun.run_cell("qwen3-4b", "long_500k", False, verbose=False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    failures = dryrun.main(["--arch", "mamba2-780m", "--shape",
                            "decode_32k,long_500k", "--mesh", "single",
                            "--moment-dtype", "int8", "--out",
                            str(tmp_path)])
    assert failures == 0
    got = sorted(os.listdir(tmp_path))
    assert got == ["mamba2-780m__decode_32k__16x16.json",
                   "mamba2-780m__long_500k__16x16.json"]
    rec = json.loads((tmp_path / got[0]).read_text())
    assert rec["status"] == "ok" and rec["overrides"] == {
        "moment_dtype": "int8"}
    assert "[dryrun] done; 0 failures" in capsys.readouterr().out


@pytest.fixture(scope="module")
def reference_small(reference_proc):
    stdout, stderr = reference_proc.communicate(timeout=600)
    assert reference_proc.returncode == 0, stderr[-4000:]
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("RESULT::")][-1]
    return json.loads(line[len("RESULT::"):])


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_argument_bytes_equal_memory_analysis(reference_small, shape,
                                              monkeypatch):
    """Smoke qwen3-4b's cell on a (2, 2) mesh: the port's per-chip
    argument bytes, reckoned from the specs, equal the reference's
    compiled ``memory_analysis()``.  The collective reckoning is printed
    beside the reference's HLO parse (information, no gate)."""
    monkeypatch.setattr(dryrun, "get_config", smoke)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_host_mesh(
                            (2, 2), ("data", "model"), device="meta"))
    rec = dryrun.run_cell("qwen3-4b", shape, False, verbose=False)
    want = reference_small[shape]
    assert rec["memory"]["argument_size_in_bytes"] == \
        want["memory"]["argument_size_in_bytes"]
    ours = {k: v for k, v in rec["collectives"].items()
            if not k.startswith("_")}
    total, ref_total = sum(ours.values()), sum(want["collectives"].values())
    print(f"[dryrun-vs-hlo] smoke qwen3-4b {shape} on (2, 2): reckoned "
          f"{json.dumps(ours)} total {total}; reference HLO parse "
          f"{json.dumps(want['collectives'])} total {ref_total}; ratio "
          f"{total / ref_total if ref_total else float('nan'):.4f}")
    assert total > 0
