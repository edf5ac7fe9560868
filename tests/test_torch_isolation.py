"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
            f"{path}: imports {mod}"


_BLOCKED_IMPORT = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import repro_torch, repro_torch.core, repro_torch.kernels, repro_torch.engine
import repro_torch.durability, repro_torch.serving, repro_torch.checkpoint
import repro_torch.ivm, repro_torch.configs, repro_torch.launch
from repro_torch.configs import SSB_PIM
from repro_torch.core.costmodel import Workload, jspim_join_seconds
from repro_torch.engine import SSBEngine, generate_ssb
from repro_torch.engine.ssb import generate_fact_batch
from repro_torch.ivm import MaintainedSuite
from repro_torch.serving import QueryScheduler
import numpy as np
assert jspim_join_seconds(Workload(1000, 100, 1000), SSB_PIM) > 0
engine = SSBEngine(generate_ssb(0.0001, device="cpu"), device="cpu")
print(sorted(engine.run_all()))
suite = MaintainedSuite.attach(engine)
engine.append_fact_rows(generate_fact_batch(engine.tables, 8,
                                            np.random.default_rng(0)))
assert suite.fresh_at(engine.epoch)
with engine.snapshot() as snap:
    assert sorted(snap.run_all()) == sorted(engine.run_all())
    assert snap.maintained is not None
sched = QueryScheduler(engine)
ticket = sched.submit("Q2.1")
sched.pump()
assert ticket.response.ok
assert sched.info()["maintained_served"] == 1
sched.close()
import tempfile
root = tempfile.mkdtemp() + "/durable"
engine.persist(root)
engine.append_fact_rows(generate_fact_batch(engine.tables, 8,
                                            np.random.default_rng(1)))
engine.close()
recovered = SSBEngine.open(root, device="cpu")
assert recovered.epoch == engine.epoch
recovered.close()
from repro_torch.engine import ShardedSSBEngine
from repro_torch.launch import make_data_mesh
import torch
batch = generate_fact_batch(generate_ssb(0.0001, device="cpu"), 7,
                            np.random.default_rng(2))
sharded = ShardedSSBEngine(generate_ssb(0.0001, device="cpu"),
                           mesh=make_data_mesh(2, device="cpu"))
sharded.append_fact_rows(batch)
assert sharded.shard_info()["dead_rows"] == 1
plain = SSBEngine(generate_ssb(0.0001, device="cpu"), device="cpu")
plain.append_fact_rows(batch)
got, want = sharded.run_all(), plain.run_all()
assert sorted(got) == sorted(want)
assert all(torch.equal(a, b) for q in want for a, b in zip(got[q], want[q]))
import repro_torch.models, repro_torch.configs, repro_torch.serve
import repro_torch.launch.serve
from repro_torch.configs import get_config, smoke
from repro_torch.models import init_params, prefill
from repro_torch.serve import Server
cfg = smoke("jamba-v0.1-52b")
srv = Server(cfg, init_params(cfg, device="cpu"), max_seq=32, batch=2,
             page_size=8, device="cpu")
prompts = torch.randint(0, cfg.vocab_size, (2, 16))
res = srv.generate(prompts, steps=3)
assert torch.equal(res.tokens[:, 0],
                   prefill(cfg, srv.params, prompts)[0].argmax(-1))
assert sum(p.numel() for p in init_params(
    get_config("kimi-k2-1t-a32b"), device="meta").parameters()) > 1e12
import repro_torch.optim, repro_torch.train, repro_torch.data
import repro_torch.launch.train
from repro_torch.optim import OptConfig
from repro_torch.train import Trainer, TrainerConfig
res = Trainer(smoke("mamba2-780m"), OptConfig(moment_dtype="int8",
                                              grad_quant_bits=8),
              TrainerConfig(steps=2, global_batch=2, seq_len=16,
                            ckpt_dir=tempfile.mkdtemp()),
              log_fn=lambda s: None, device="cpu").run()
assert len(res["losses"]) == 2
import dataclasses
import repro_torch.launch.dryrun, repro_torch.launch.roofline
from repro_torch.launch import make_host_mesh
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.elastic import reshard_params
from repro_torch.launch.sharding import activate, param_specs
from repro_torch.optim import psum_compressed
assert run_cell("qwen3-4b", "decode_32k", True, verbose=False)["status"] == "ok"
mesh = make_host_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
kimi = dataclasses.replace(smoke("kimi-k2-1t-a32b"), moe_groups=4)
with activate(mesh):
    res = Trainer(kimi, OptConfig(), TrainerConfig(
        steps=1, global_batch=4, seq_len=16, ckpt_dir=tempfile.mkdtemp()),
        mesh=mesh, log_fn=lambda s: None).run()
    assert param_specs(res["params"])["embed"]["tokens"] == (
        ("pod", "data"), "model")
re = reshard_params(res["params"], make_host_mesh(device="cpu"))
assert all(torch.equal(a, b) for a, b in zip(res["params"].parameters(),
                                             re.parameters()))
g = torch.ones(2, 3, 300)
assert torch.equal(psum_compressed([g], "pod", mesh)[0], 2 * g)
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
               for m in sys.modules)
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Q4.3" in out.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_generate_ssb_without_device_raises(no_card):
    from repro_torch.engine import generate_ssb, generate_ssb_dims
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_ssb(0.0001)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_ssb_dims(0.0001)
    with pytest.raises(RuntimeError):
        generate_ssb(0.0001, device="cuda")


def test_engine_without_device_raises(no_card):
    from repro_torch.engine import SSBEngine, generate_ssb
    tables = generate_ssb(0.0001, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSBEngine(tables)


def test_init_params_without_device_raises(no_card):
    from repro_torch.configs import smoke
    from repro_torch.models import init_caches, init_params
    cfg = smoke("qwen3-4b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_caches(cfg, 2, 8)
    assert init_params(cfg, device="cpu").embed.tokens.device.type == "cpu"


def test_server_and_page_table_without_device_raise(no_card):
    from repro_torch.configs import smoke
    from repro_torch.models import init_params
    from repro_torch.serve import PageTable, Server
    cfg = smoke("qwen3-4b")
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(cfg, params, max_seq=16, batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PageTable(n_physical=4, max_pages_per_seq=2)
    assert PageTable(4, 2, device="cpu").device.type == "cpu"


def test_serve_cli_without_device_raises(no_card):
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "qwen3-4b", "--smoke"])


def test_open_without_device_raises(no_card, tmp_path):
    """Recovery lands on the card unless the caller asks for the CPU."""
    from repro_torch.engine import SSBEngine, generate_ssb
    root = str(tmp_path / "durable")
    SSBEngine(generate_ssb(0.0001, device="cpu"), device="cpu").persist(root)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSBEngine.open(root)
    assert SSBEngine.open(root, device="cpu").epoch == 0


def test_training_without_device_raises(no_card, tmp_path):
    import numpy as np
    from repro_torch.configs import smoke
    from repro_torch.data import shard_batch
    from repro_torch.launch.train import main
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer, TrainerConfig, init_train_state
    cfg = smoke("qwen3-4b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, OptConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, OptConfig(), TrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shard_batch({"tokens": np.zeros((2, 4), np.int32)}, None, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "qwen3-4b", "--smoke", "--steps", "1",
              "--ckpt-dir", str(tmp_path)])
    params, state = init_train_state(cfg, OptConfig(), device="cpu")
    assert params.embed.tokens.device.type == "cpu"
    assert state["step"].device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card: exit non-zero and print no result line.  Alone in a
    directory, without the package, it fails all the same."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(script), "--sf", "0.0001"],
                         cwd=script.parent, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
