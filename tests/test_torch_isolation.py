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
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


_BLOCKED_IMPORT = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import repro_torch, repro_torch.core, repro_torch.kernels, repro_torch.engine
import repro_torch.durability, repro_torch.serving, repro_torch.checkpoint
import repro_torch.ivm, repro_torch.configs
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
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
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


def test_open_without_device_raises(no_card, tmp_path):
    """Recovery lands on the card unless the caller asks for the CPU."""
    from repro_torch.engine import SSBEngine, generate_ssb
    root = str(tmp_path / "durable")
    SSBEngine(generate_ssb(0.0001, device="cpu"), device="cpu").persist(root)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSBEngine.open(root)
    assert SSBEngine.open(root, device="cpu").epoch == 0


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
