"""Training launcher: --arch <id> on one device or a host region mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --smoke --device cpu --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
      --steps 100 --batch 8 --microbatches 2 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --smoke --device cpu --mesh host2x2 --steps 4

Runs on the card unless ``--device`` names another: make mesh -> make
state -> ``Trainer.run()`` with auto-resume from ``--ckpt-dir``.  ``--mesh
host2x2`` is a (2, 2) ``("data", "model")`` region mesh on that device;
as in the reference, the Trainer shards each batch over it.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, smoke
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host2x2"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = None
    if args.mesh == "host2x2":
        mesh = make_host_mesh(device=args.device)
    opt = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                    total_steps=args.steps, moment_dtype=args.moment_dtype)
    tc = TrainerConfig(steps=args.steps, global_batch=args.batch,
                       microbatches=args.microbatches, seq_len=args.seq,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)
    res = Trainer(cfg, opt, tc, mesh=mesh, device=args.device).run()
    print(f"[train] done; final loss {res['losses'][-1]:.4f}; "
          f"stragglers {res['straggler_events']}")
    return res


if __name__ == "__main__":
    main()
