"""Multi-pod dry-run: size every (arch × shape × mesh) cell without a device.

PyTorch port of ``repro.launch.dryrun``.  For each cell this builds the
full sharding config (FSDP+TP parameters, EP experts, sharded optimizer
state, sharded KV caches) on the 256-chip single-pod or 512-chip two-pod
``ShardMesh`` of ``make_production_mesh``, with every tensor on the
``meta`` device: nothing is allocated and nothing is compiled.  Where the
reference reads XLA's compiled module, the port reckons:

* per-chip argument bytes exactly from the specs (each leaf's bytes over
  the product of the axis sizes its spec names);
* outputs, aliases and temporaries from the step's structure
  (``_memory``), where the reference reads ``memory_analysis()``;
* FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` over one real
  step on ``meta`` tensors, as a cross-check column (the reference keeps
  ``cost_analysis()`` for this);
* the compute and memory terms from ``roofline.analytic_cost``, as the
  reference does, and collective bytes from ``roofline.collective_bytes``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
      --out reports/dryrun
Hillclimb knobs: --no-dedup-embed --moment-dtype int8 --microbatches N
                 --remat none --attn-chunk N
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, list_archs, shape_applicable
from repro_torch.configs.shapes import SHAPES, input_specs
from repro_torch.launch import roofline
from repro_torch.launch.mesh import Placement, dp_size, make_production_mesh
from repro_torch.launch.sharding import (activate, map_tree, named_shardings,
                                         param_specs, resolve)
from repro_torch.models.transformer import (decode_step, init_caches,
                                            init_params, loss_fn, prefill)
from repro_torch.optim.adamw import OptConfig, init_opt_state


# ---------------------------------------------------------------------------
# sharding helpers (the reference's, on specs as tuples)
# ---------------------------------------------------------------------------

def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    axes = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _pick_spec(shape, mesh, prefs) -> tuple:
    """prefs: [(dim, logical_axis)] tried in order; a dim is sharded only if
    divisible by the axis size and the axis is still unused."""
    spec: list = [None] * len(shape)
    used: set = set()
    for dim, logical in prefs:
        axes = resolve(logical, tuple(mesh.axis_names))
        if axes is None:
            continue
        tup = axes if isinstance(axes, tuple) else (axes,)
        if any(a in used for a in tup):
            continue
        if spec[dim] is not None:
            continue
        if shape[dim] % _axes_size(mesh, tup) == 0 and shape[dim] > 0:
            spec[dim] = axes
            used.update(tup)
    return tuple(spec)


def _cache_shardings(cfg, caches_shape, mesh):
    """Placement tree for the stacked cache pytree (per pattern pos)."""
    out = []
    for (mixer, _), c in zip(cfg.pattern, caches_shape):
        if mixer in ("attn", "xattn"):
            # KVCache k/v: (R, B, S, KH, hd) — batch over dp; kv-heads over
            # tp when divisible, else the sequence dim
            sh = Placement(mesh, _pick_spec(
                c.k.shape, mesh, [(1, "dp"), (3, "tp"), (2, "tp")]))
            out.append(type(c)(sh, sh))
        else:
            # MambaState h: (R, B, nh, hd, N); conv: (R, B, W-1, C)
            h_sh = Placement(mesh, _pick_spec(
                c.h.shape, mesh, [(1, "dp"), (2, "tp")]))
            conv_sh = Placement(mesh, _pick_spec(
                c.conv.shape, mesh, [(1, "dp"), (3, "tp")]))
            out.append(type(c)(h_sh, conv_sh))
    return out


def _sanitize(spec, shape, mesh) -> tuple:
    """Drop sharding on dims not divisible by the axis size (e.g. a 50280
    vocab over 16-way dp falls back to replication on that dim)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    new = []
    for dim, ax in zip(shape, entries):
        if ax is None or dim % _axes_size(mesh, ax) != 0:
            new.append(None)
        else:
            new.append(ax)
    return tuple(new)


def _batch_shardings(specs, mesh):
    def one(leaf):
        nd = len(leaf.shape)
        if nd >= 2:
            # (MB, per, ...) train or (B, ...) serve: shard the batch dim
            dim = 1 if nd >= 3 else 0
            return Placement(mesh, _pick_spec(leaf.shape, mesh,
                                              [(dim, "dp")]))
        return Placement(mesh, ())
    return {k: one(v) for k, v in specs.items()}


def _is_q(x) -> bool:
    return isinstance(x, dict) and "q" in x


def _opt_shardings(opt_shape, p_specs, mesh):
    def one(leaf, sp):
        if _is_q(leaf):  # int8 {q, s}: the last dim
            # is blocked, so q and s both gain ONE trailing dim;
            # re-sanitize (block counts may not divide the axis)
            base = tuple(sp) + (None,)
            return {"q": Placement(mesh, _sanitize(
                        base, leaf["q"].shape, mesh)),
                    "s": Placement(mesh, _sanitize(
                        base, leaf["s"].shape, mesh))}
        return Placement(mesh, sp)

    def walk(tree, spec_tree):
        if _is_q(tree) or not isinstance(tree, (dict, list)):
            return one(tree, spec_tree)
        if isinstance(tree, dict):
            return {k: walk(v, spec_tree[k]) for k, v in tree.items()}
        return [walk(v, s) for v, s in zip(tree, spec_tree)]

    out = {"step": Placement(mesh, ())}
    for k in ("m", "v", "err"):
        if k in opt_shape:
            out[k] = walk(opt_shape[k], p_specs)
    return out


# ---------------------------------------------------------------------------
# reckonings
# ---------------------------------------------------------------------------

def _pairs(tree, shardings):
    """(tensor, Placement) per leaf of ``tree`` (dicts, lists, tuples and
    ``ParamTree``s as nodes)."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.tree()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, shardings[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, shardings):
            yield from _pairs(v, s)
    else:
        yield tree, shardings


def chip_bytes(t: torch.Tensor, placement: Placement | None) -> int:
    """Bytes of ``t`` on one chip: its bytes over the product of the axis
    sizes its spec names (every sharded dim divides its axes here)."""
    n = t.numel() * t.element_size()
    if placement is None:
        return n
    ways = math.prod(_axes_size(placement.mesh, e) for e in placement.spec)
    return n // ways


def argument_bytes(args, shardings) -> int:
    """Per-chip bytes of a step's arguments, exactly from the specs."""
    return sum(chip_bytes(t, s) for t, s in _pairs(args, shardings))


def _memory(kind, cfg, args, arg_sh, params, p_sh, rows, seq_len,
            caches=None, cache_sh=None) -> dict:
    """The reference's ``memory_analysis()`` keys, reckoned.  Arguments
    are exact.  Outputs: training returns the donated parameters and
    optimizer state (aliased) and three float32 metrics; prefill the
    float32 last-token logits (replicated) and the ``caches``; decode the
    logits and the donated caches.  Temporaries, an estimate: in training
    the float32 gradient accumulator (sharded as the parameters), one
    ``(rows, S, D)`` block input kept per repeat under block remat and one
    pattern repeat's internals at the analytic model's ``2·D·8`` bytes a
    token a layer; in prefill one layer's internals; none in decode.
    ``rows`` is the batch rows one chip holds."""
    arg = argument_bytes(args, arg_sh)
    elem = 2 if cfg.dtype == "bfloat16" else 4
    tokens = rows * (seq_len if kind != "decode" else 1)
    internals = 2 * cfg.d_model * 8 * tokens
    logits = rows * cfg.vocab_size * 4
    if kind == "train":
        alias = argument_bytes(args[:2], arg_sh[:2])
        out = alias + 3 * 4
        acc = sum(chip_bytes(t, s) // t.element_size() * 4
                  for t, s in _pairs(params, p_sh))
        temp = (acc + cfg.n_repeats * tokens * cfg.d_model * elem
                + len(cfg.pattern) * internals)
    elif kind == "prefill":
        alias = 0
        out = logits + argument_bytes(caches, cache_sh)
        temp = internals
    else:
        alias = argument_bytes(args[1], arg_sh[1])
        out = logits + alias
        temp = 0
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
            "temp_size_in_bytes": temp, "alias_size_in_bytes": alias,
            "per_chip_bytes": arg - alias + out + temp}


def _count_flops(cfg, step) -> float:
    """FLOPs of ``step(cfg, params)`` on ``meta`` by ``FlopCounterMode``.
    Every pattern repeat costs the same, so the count runs at one and two
    repeats and extrapolates to ``cfg.n_repeats`` (exact)."""
    def at(r):
        c = dataclasses.replace(cfg, n_layers=r * len(cfg.pattern))
        with FlopCounterMode(display=False) as fc:
            step(c, init_params(c, device="meta"))
        return fc.get_total_flops()
    f1 = at(1)
    if cfg.n_repeats == 1:
        return float(f1)
    f2 = at(2)
    return float(f1 + (f2 - f1) * (cfg.n_repeats - 1))


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape: str, multi_pod: bool,
             overrides: dict | None = None, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides.items()
                                          if hasattr(cfg, k)})
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "overrides": {k: str(v) for k, v in (overrides or {}).items()}}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    sp = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    dp = dp_size(mesh)
    mb_override = (overrides or {}).get("microbatches")
    moment_dtype = (overrides or {}).get("moment_dtype", "float32")
    t0 = time.time()

    with activate(mesh):
        params = init_params(cfg, device="meta")
        p_specs = map_tree(lambda _, leaf, s: _sanitize(s, leaf.shape, mesh),
                           params, param_specs(params))
        opt_specs = p_specs  # moments mirror the parameter layout
        if (overrides or {}).get("no_fsdp"):
            # ZeRO-1: parameters/grads replicated over dp (TP-sharded only);
            # optimizer moments stay dp-sharded
            def _strip(_, s):
                def drop(e):
                    if e is None:
                        return None
                    tup = e if isinstance(e, tuple) else (e,)
                    kept = tuple(a for a in tup if a not in ("data", "pod"))
                    return kept if len(kept) > 1 else (
                        kept[0] if kept else None)
                return tuple(drop(e) for e in s)
            p_specs = map_tree(_strip, p_specs)
        p_sh = named_shardings(mesh, p_specs)

        if sp.kind == "train":
            mb = mb_override or min(sp.microbatches,
                                    max(1, sp.global_batch // dp))
            per = sp.global_batch // mb
            # re-derive microbatch layout for this mesh
            specs = {k: torch.empty((mb, per) + tuple(v.shape[2:]),
                                    dtype=v.dtype, device="meta")
                     for k, v in input_specs(cfg, shape).items()}
            opt_cfg = OptConfig(moment_dtype=moment_dtype)
            opt_state = init_opt_state(params, opt_cfg)
            opt_sh = _opt_shardings(opt_state, opt_specs, mesh)
            batch_sh = _batch_shardings(specs, mesh)
            args, arg_sh = (params, opt_state, specs), (p_sh, opt_sh, batch_sh)
            rows = per // dp if per % dp == 0 else per
            tokens = sp.global_batch * sp.seq_len
            rec["microbatches"] = mb

            def step(c, p):
                im = specs.get("image_embeds")
                loss_fn(c, p, specs["tokens"][0], specs["labels"][0],
                        None if im is None else im[0]).backward()
            count_mult = mb

        elif sp.kind == "prefill":
            specs = input_specs(cfg, shape)
            batch_sh = _batch_shardings(specs, mesh)
            caches = init_caches(cfg, sp.global_batch, sp.seq_len,
                                 cfg.n_image_tokens, device="meta")
            cache_sh = _cache_shardings(cfg, caches, mesh)
            args = (params, specs["tokens"])
            arg_sh = (p_sh, batch_sh["tokens"])
            if "image_embeds" in specs:
                args += (specs["image_embeds"],)
                arg_sh += (batch_sh["image_embeds"],)
            rows = (sp.global_batch // dp if sp.global_batch % dp == 0
                    else sp.global_batch)
            tokens = sp.global_batch * sp.seq_len

            def step(c, p):
                prefill(c, p, specs["tokens"], max_seq=sp.seq_len,
                        image_embeds=specs.get("image_embeds"))
            count_mult = 1

        else:  # decode
            specs = input_specs(cfg, shape)
            caches = init_caches(cfg, sp.global_batch, sp.seq_len,
                                 cfg.n_image_tokens, device="meta")
            cache_sh = _cache_shardings(cfg, caches, mesh)
            tok_sh = Placement(mesh, _pick_spec(specs["token"].shape, mesh,
                                                [(0, "dp")]))
            args = (params, caches, specs["token"], specs["pos"])
            arg_sh = (p_sh, cache_sh, tok_sh, Placement(mesh, ()))
            rows = (sp.global_batch // dp if sp.global_batch % dp == 0
                    else sp.global_batch)
            tokens = sp.global_batch  # one new token per sequence

            def step(c, p):
                decode_step(c, p, init_caches(c, sp.global_batch,
                                              sp.seq_len, c.n_image_tokens,
                                              device="meta"),
                            specs["token"], sp.seq_len - 1)
            count_mult = 1

        mem = _memory(sp.kind, cfg, args, arg_sh, params, p_sh, rows,
                      sp.seq_len, *((caches, cache_sh)
                                    if sp.kind == "prefill" else ()))
        leaves = [(path, tuple(t.shape), t.element_size(), pl.spec)
                  for (path, t), (_, pl) in zip(_named(params),
                                                _named(p_sh))]
        t_build = time.time() - t0
        t0 = time.time()
        flops_counted = _count_flops(cfg, step) * count_mult
        t_count = time.time() - t0

    n_chips = math.prod(mesh.sizes)
    coll = roofline.collective_bytes(
        cfg, sp.kind, mesh, leaves, sp.global_batch, sp.seq_len,
        rec.get("microbatches", 1))
    mf = roofline.model_flops_for(cfg, sp.kind, tokens)
    an = roofline.analytic_cost(cfg, sp.kind, sp.global_batch, sp.seq_len,
                                n_chips)
    # compute/memory terms from the analytic model (the FLOP counter is
    # kept in the record as a cross-check only); collective bytes from
    # the reckoning over the shardings.
    coll_total = sum(v for k, v in coll.items() if not k.startswith("_"))
    terms = roofline.RooflineTerms(
        compute_s=an["flops_per_chip"] / roofline.PEAK_FLOPS,
        memory_s=an["hbm_bytes_per_chip"] / roofline.HBM_BW,
        collective_s=coll_total / roofline.LINK_BW,
        flops_per_chip=an["flops_per_chip"],
        hbm_bytes_per_chip=an["hbm_bytes_per_chip"],
        collective_bytes_per_chip=coll_total,
        bytes_per_chip=mem["per_chip_bytes"],
        model_flops=mf,
        useful_flops_frac=(mf / (an["flops_per_chip"] * n_chips)
                           if an["flops_per_chip"] else 0.0),
    )
    rec.update(
        status="ok",
        build_s=round(t_build, 1), count_s=round(t_count, 1),
        tokens=tokens,
        cost={"flops": flops_counted / n_chips},
        memory=mem,
        collectives=coll,
        roofline=dataclasses.asdict(terms),
        dominant=terms.dominant,
        roofline_frac=round(terms.roofline_frac, 4),
        fits_h100=mem["per_chip_bytes"] <= roofline.HBM_CAP_H100,
        n_params=cfg.param_count(),
        n_active_params=cfg.active_param_count(),
    )
    if verbose:
        print(f"[dryrun] {arch} × {shape} × {rec['mesh']}: "
              f"build {t_build:.1f}s count {t_count:.1f}s "
              f"dominant={terms.dominant} "
              f"bytes/chip={mem['per_chip_bytes'] / 2**30:.2f}GiB "
              f"fits_h100={rec['fits_h100']}")
        print("  memory (reckoned):", mem)
        print("  flops/chip analytic=%.3e counted=%.3e hbm bytes/chip=%.3e"
              % (terms.flops_per_chip, rec["cost"]["flops"],
                 terms.hbm_bytes_per_chip))
        print("  collectives:", coll["_counts"])
    return rec


def _named(tree):
    """(path, leaf) over a ParamTree / dict / list tree, '/'-joined."""
    out = []
    map_tree(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="reports/dryrun")
    ap.add_argument("--no-dedup-embed", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="ZeRO-1: params TP-only, moments dp-sharded")
    ap.add_argument("--moe-groups", type=int, default=0,
                    help="grouped (dp-local) MoE dispatch")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel block boundaries")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--attn-chunk", type=int, default=0)
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    overrides: dict = {}
    if args.no_dedup_embed:
        overrides["dedup_embed"] = False
    if args.no_fsdp:
        overrides["no_fsdp"] = True
    if args.moe_groups:
        overrides["moe_groups"] = args.moe_groups
    if args.sp:
        overrides["sp"] = True
    if args.moment_dtype != "float32":
        overrides["moment_dtype"] = args.moment_dtype
    if args.microbatches:
        overrides["microbatches"] = args.microbatches
    if args.remat:
        overrides["remat"] = args.remat
    if args.attn_chunk:
        overrides["attn_chunk"] = args.attn_chunk
    if args.loss_chunk:
        overrides["loss_chunk"] = args.loss_chunk

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"__{args.tag}" if args.tag else ""
                fn = os.path.join(
                    args.out,
                    f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}{tag}.json")
                if args.skip_existing and os.path.exists(fn):
                    print(f"[dryrun] skip existing {fn}")
                    continue
                try:
                    rec = run_cell(arch, shape, mp, overrides or None)
                except Exception as e:  # a failed cell is recorded, the
                    # sweep goes on; the exit code reports it
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    failures += 1
                    print(f"[dryrun] FAIL {arch} × {shape}: {e!r}")
                with open(fn, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"[dryrun] done; {failures} failures")
    return failures


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
