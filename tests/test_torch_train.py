"""LM training in the port, on the CPU, beside the JAX package.

A leaf autograd leaves without ``.grad`` (``q_norm``/``k_norm`` with
``qk_norm`` off) is JAX's zero, and AdamW still decays it.  The three
trainer cases of ``tests/test_system.py`` (the crash-restart case also
against an uninterrupted twin, bit for bit), the data pipeline (Zipf
batches bit-identical to the reference's), the CLI and the optimizer's
in-place update of a ``ParamTree``.  Gradients against
``jax.value_and_grad`` and remat are in ``tests/test_torch_train_grads.py``;
the train step against the reference's, the SSD gradient at the
published chunk and the checkpoints that cross between the packages in
``tests/test_torch_train_compat.py``.
"""
import dataclasses
import statistics
import tempfile
import time

import numpy as np
import pytest
import torch

from repro.data import Prefetcher as JPrefetcher
from repro.data import ZipfTokenStream as JZipf
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import smoke
from repro_torch.data import Prefetcher, ZipfTokenStream, shard_batch
from repro_torch.launch import Placement, make_host_mesh
from repro_torch.models import loss_fn
from repro_torch.optim import OptConfig, apply_updates, init_opt_state
from repro_torch.optim.adamw import tree_map, walk
from repro_torch.train import (Trainer, TrainerConfig, init_train_state,
                               make_train_step)


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


def test_unused_leaves_decay_as_in_jax():
    """``q_norm``/``k_norm`` with ``qk_norm`` off: no ``.grad`` in the port,
    zeros in JAX; the train step accumulates zeros and AdamW decays them."""
    cfg = dataclasses.replace(smoke("musicgen-large"), qk_norm=False)
    params = init_train_state(cfg, OptConfig(), device="cpu")[0]
    tok = _tokens(cfg, (2, 16))
    _, got = _port_grads(cfg, params, tok, np.roll(tok, -1, 1))
    unused = [n for n, g in got.items() if g is None]
    assert unused and all(n.endswith(("q_norm", "k_norm")) for n in unused)
    with torch.no_grad():
        for n, p in params.named_parameters():
            if n in unused:
                p.fill_(0.5)
    opt = OptConfig(lr=1e-2, warmup_steps=0, weight_decay=0.1)
    batch = shard_batch({"tokens": tok, "labels": np.roll(tok, -1, 1)},
                        None, 1, device="cpu")
    make_train_step(cfg, opt)(params, init_opt_state(params, opt), batch)
    for n, p in params.named_parameters():
        if n in unused:    # decayed by lr x wd, moved by nothing else
            assert torch.allclose(p, torch.full_like(p, 0.5 * (1 - 1e-3)))


# ---------------------------------------------------------------------------
# the trainer cases of tests/test_system.py
# ---------------------------------------------------------------------------

def test_train_crash_restart_continues():
    cfg = smoke("qwen3-4b")
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=14)
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(steps=14, global_batch=4, microbatches=2,
                           seq_len=48, ckpt_every=4, log_every=100,
                           ckpt_dir=d)
        with pytest.raises(RuntimeError):
            Trainer(cfg, opt, tc, log_fn=lambda s: None,
                    device="cpu").run(fail_at_step=9)
        res = Trainer(cfg, opt, tc, log_fn=lambda s: None,
                      device="cpu").run()
        assert len(res["losses"]) == 14 - 8  # resumed from step-8 checkpoint
        assert np.isfinite(res["losses"][-1])
        assert res["losses"][-1] < 7.0
        # the resumed run equals an uninterrupted one bit for bit
        with tempfile.TemporaryDirectory() as d2:
            twin = Trainer(cfg, opt, dataclasses.replace(tc, ckpt_dir=d2),
                           log_fn=lambda s: None, device="cpu").run()
        assert twin["losses"][8:] == res["losses"]
        for (_, a), (_, b) in zip(_flatten(twin["params"].tree()),
                                  _flatten(res["params"].tree())):
            assert torch.equal(a, b)


def test_straggler_watchdog_fires():
    cfg = smoke("musicgen-large")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=12)
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(steps=12, global_batch=2, microbatches=1,
                           seq_len=32, ckpt_every=100, log_every=100,
                           ckpt_dir=d, straggler_factor=3.0)
        tr = Trainer(cfg, opt, tc, log_fn=lambda s: None, device="cpu")
        orig = tr.train_step

        calls = {"n": 0}

        def slow_step(*a, **k):
            calls["n"] += 1
            if calls["n"] == 9:
                # injected straggler: well past 3x the median so far
                time.sleep(max(1.5, 6 * statistics.median(tr.step_times)))
            return orig(*a, **k)

        tr.train_step = slow_step
        res = tr.run()
        assert res["straggler_events"] >= 1


def test_loss_decreases_with_jspim_paths_enabled():
    cfg = smoke("qwen3-4b")  # dedup_embed on by default
    opt = OptConfig(lr=2e-3, warmup_steps=2, total_steps=20)
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(steps=20, global_batch=4, microbatches=1,
                           seq_len=64, ckpt_every=100, log_every=100,
                           ckpt_dir=d, zipf_s=1.2)
        res = Trainer(cfg, opt, tc, log_fn=lambda s: None,
                      device="cpu").run()
        first = np.mean(res["losses"][:3])
        last = np.mean(res["losses"][-3:])
        assert last < first - 0.2, (first, last)


# ---------------------------------------------------------------------------
# data pipeline and CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,zipf_s,burst", [(0, 1.1, 4), (3, 1.2, 4),
                                               (7, 0.0, 1), (11, 1.5, 3)])
def test_zipf_stream_bit_identical_to_reference(seed, zipf_s, burst):
    ours = ZipfTokenStream(1000, 64, zipf_s=zipf_s, burst_len=burst,
                           seed=seed)
    ref = JZipf(1000, 64, zipf_s=zipf_s, burst_len=burst, seed=seed)
    for step in (0, 1, 5, 123):
        a, b = ours.batch(step, 4), ref.batch(step, 4)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    it, jt = ours.batches(2, start_step=9), ref.batches(2, start_step=9)
    for _ in range(3):
        np.testing.assert_array_equal(next(it)["tokens"], next(jt)["tokens"])
    # seekable: labels are next-token targets
    a = ours.batch(5, 4)
    assert np.array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_shard_batch_microbatch_layout():
    b = ZipfTokenStream(vocab_size=100, seq_len=16).batch(0, 8)
    out = shard_batch(b, mesh=None, microbatches=4, device="cpu")
    assert out["tokens"].shape == (4, 2, 16)
    assert out["tokens"].dtype == torch.int32
    assert torch.equal(out["tokens"].reshape(8, 16),
                       torch.from_numpy(b["tokens"]))
    mesh = make_host_mesh((2, 2), ("data", "model"), device="cpu")
    out = shard_batch(b, mesh=mesh, microbatches=4)
    assert out["tokens"].shape == (4, 2, 16)
    assert out["tokens"].placement == Placement(mesh, (None, ("data",), None))
    assert torch.equal(out["tokens"].reshape(8, 16),
                       torch.from_numpy(b["tokens"]))


def test_prefetcher_order():
    got = [b["x"] for b in Prefetcher(iter([{"x": i} for i in range(5)]),
                                      depth=2)]
    want = [b["x"] for b in JPrefetcher(iter([{"x": i} for i in range(5)]),
                                        depth=2)]
    assert got == want == [0, 1, 2, 3, 4]


def test_train_cli_smoke_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    res = main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                "--steps", "4", "--batch", "4", "--seq", "32",
                "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(res["losses"]) == 4 and np.isfinite(res["losses"]).all()
    assert "[train] done; final loss" in capsys.readouterr().out
    assert (tmp_path / "ckpt" / "step_00000004").is_dir()
    res = main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                "--mesh", "host2x2", "--steps", "2", "--batch", "4",
                "--seq", "16", "--ckpt-dir", str(tmp_path / "mesh")])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()


def test_trainer_rejects_a_mesh(tmp_path):
    """A mesh whose dp regions do not divide a microbatch's rows is
    refused at the first batch, as the reference's ``device_put`` refuses
    it; one that divides them trains on its device."""
    cfg = smoke("qwen3-4b")
    tc = TrainerConfig(steps=1, global_batch=6, microbatches=2, seq_len=16,
                       ckpt_dir=str(tmp_path))
    mesh = make_host_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="dp regions"):
        Trainer(cfg, OptConfig(), tc, mesh=mesh, log_fn=lambda s: None).run()
    res = Trainer(cfg, OptConfig(), dataclasses.replace(tc, global_batch=4),
                  mesh=mesh, log_fn=lambda s: None).run()
    assert res["params"].embed.tokens.device == mesh.device


def test_apply_updates_keeps_parameter_identity():
    cfg = smoke("mamba2-780m")
    opt = OptConfig(moment_dtype="int8", grad_quant_bits=8)
    params, state = init_train_state(cfg, opt, device="cpu")
    before = {n: (id(p), p.detach().clone()) for n, p in
              params.named_parameters()}
    grads = tree_map(lambda p: torch.ones_like(p), params.tree())
    out, state, met = apply_updates(params, grads, state, opt)
    assert out is params and int(state["step"]) == 1
    for n, p in params.named_parameters():
        assert id(p) == before[n][0] and isinstance(p, torch.nn.Parameter)
        assert not torch.equal(p.detach(), before[n][1]), n
    for (p, m) in walk(params.tree(), state["m"]):
        assert set(m) == {"q", "s"} and m["q"].dtype == torch.int8
