"""Serving launcher: batched greedy decode with the JSPIM integrations.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --batch 8 --prompt-len 256 --steps 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \
      --smoke --device cpu

Runs on the card unless ``--device`` names another.  The weights are
random, from ``--seed``; so are the prompts.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, smoke
from repro_torch.engine.table import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, seed=args.seed, device=dev)
    max_seq = args.max_seq or (args.prompt_len + args.steps + 8)
    srv = Server(cfg, params, max_seq=max_seq, batch=args.batch, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    image_embeds = None
    if cfg.n_image_tokens:
        image_embeds = torch.randn(
            (args.batch, cfg.n_image_tokens, cfg.d_model), generator=gen,
            device=dev).to(getattr(torch, cfg.dtype))
    t0 = time.time()
    res = srv.generate(prompts, steps=args.steps, image_embeds=image_embeds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"[serve] {args.batch}×{args.steps} tokens in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s); "
          f"pages={len(srv.pages._map)}")
    print(res.tokens[0])
    return res


if __name__ == "__main__":
    main()
