"""Fault-tolerant training loop.

PyTorch port of ``repro.train.trainer``:
 * **checkpoint/restart**: atomic rotating checkpoints of (params, opt
   state); ``run()`` auto-resumes from the newest one, so a killed job
   restarted with the same command continues exactly (the data stream is
   seekable by step).  The parameters are saved as the reference's
   dict/list tree (``ParamTree.tree()``) and the optimizer state as the
   reference's tree, so a checkpoint written by either package resumes
   in the other.
 * **straggler mitigation**: a step-time watchdog tracks a robust moving
   median; steps slower than ``straggler_factor`` x median are counted and
   surfaced in the result.  A step's time runs from its batch to
   ``float(loss)``, which waits for the device.
 * **mesh**: ``Trainer(mesh=)`` places each batch on the mesh
   (``data.shard_batch``), as the reference does; the model takes the
   mesh's paths (the manual MoE dispatch) where the caller activates it
   (``launch.sharding.activate``), and ``launch/elastic.py`` re-places a
   restored state onto another mesh.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Callable

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import ZipfTokenStream, shard_batch
from repro_torch.engine.table import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import ParamTree
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    microbatches: int = 1
    seq_len: int = 128
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    keep_ckpts: int = 3
    straggler_factor: float = 2.0
    zipf_s: float = 1.1
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, opt: OptConfig, tc: TrainerConfig,
                 mesh=None, log_fn: Callable[[str], None] = print,
                 device=None):
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        self.cfg, self.opt, self.tc, self.mesh = cfg, opt, tc, mesh
        self.log = log_fn
        self.ckpt = CheckpointManager(tc.ckpt_dir, keep=tc.keep_ckpts)
        self.stream = ZipfTokenStream(cfg.vocab_size, tc.seq_len,
                                      zipf_s=tc.zipf_s, seed=tc.seed)
        self.train_step = make_train_step(cfg, opt)
        self.step_times: list[float] = []
        self.straggler_events = 0

    def _state_template(self):
        """The checkpointed tree's shapes and dtypes, on ``meta``."""
        params, opt_state = init_train_state(self.cfg, self.opt, self.tc.seed,
                                             "meta")
        return params.tree(), opt_state

    def run(self, fail_at_step: int | None = None) -> dict:
        """Train; ``fail_at_step`` injects a crash (fault-tolerance tests)."""
        tc = self.tc
        start = self.ckpt.latest()
        if start is not None:
            tree, opt_state = self.ckpt.restore_latest(
                self._state_template(), device=self.device)[1]
            params = ParamTree(tree)
            self.log(f"[trainer] resumed from step {start}")
        else:
            params, opt_state = init_train_state(self.cfg, self.opt, tc.seed,
                                                 self.device)
            start = 0
        losses = []
        for step in range(start, tc.steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.time()
            batch = shard_batch(self.stream.batch(step, tc.global_batch),
                                self.mesh, tc.microbatches,
                                device=self.device)
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            self._watchdog(dt, step)
            if (step + 1) % tc.ckpt_every == 0 or step + 1 == tc.steps:
                self.ckpt.save(step + 1, (params.tree(), opt_state))
            if (step + 1) % tc.log_every == 0:
                self.log(f"[trainer] step {step + 1} loss {loss:.4f} "
                         f"({dt * 1e3:.0f} ms)")
        return {"params": params, "opt_state": opt_state, "losses": losses,
                "straggler_events": self.straggler_events}

    def _watchdog(self, dt: float, step: int):
        self.step_times.append(dt)
        hist = self.step_times[-50:]
        if len(hist) >= 5:
            med = statistics.median(hist)
            if dt > self.tc.straggler_factor * med and step > 2:
                self.straggler_events += 1
                self.log(f"[trainer] straggler: step {step} took "
                         f"{dt * 1e3:.0f} ms (median {med * 1e3:.0f} ms)")
