"""AdamW with optional 8-bit (blockwise-quantized) moments.

PyTorch port of ``repro.optim.adamw``.  8-bit moments store m and v as
int8 with one float32 scale per 256-element block along the last dim
(dynamic blockwise quantization), cutting optimizer-state memory 4x; the
master update still happens in float32.

The state is the reference's tree: ``{"step", "m", "v"}`` (plus ``"err"``,
the error-feedback residual, when ``grad_quant_bits`` is set), ``m`` and
``v`` shaped like the parameters' dict/list tree, an int8 moment a
``{"q": int8, "s": float32}`` dict.  ``apply_updates`` writes parameters
and moments in place under ``no_grad`` (each ``nn.Parameter`` keeps its
identity), a slice of a leaf's rows (its leading dims flattened) at a
time: the reference's whole-leaf float32 temporaries would be GBs each
for a stacked leaf at full width.  A block lies along the last dim, so
slicing the rows quantizes the same blocks bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch
import torch.nn.functional as F

QBLOCK = 256
# elements of one slice of the update (its float32 temporaries are a few
# times this many bytes x 4)
SLICE_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # "float32" | "int8"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # QSGD-style gradient quantization with error feedback (models the
    # compressed cross-pod all-reduce; see optim/compress.py)
    grad_quant_bits: int = 0           # 0 = off, 8 = int8


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac (float32)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


# ---------------------------------------------------------------------------
# blockwise int8 moment quantization
# ---------------------------------------------------------------------------

def _quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 along the LAST dim only, leading dims kept."""
    if x.dim() == 0:
        x = x[None]
    *lead, last = x.shape
    pad = (-last) % QBLOCK
    xb = F.pad(x, (0, pad)).reshape(*lead, (last + pad) // QBLOCK, QBLOCK)
    scale = xb.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xb / torch.clamp_min(scale, 1e-20)).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    x = q.to(torch.float32) * scale
    *lead, nb, qb = x.shape
    x = x.reshape(*lead, nb * qb)
    last = shape[-1] if len(shape) else 1
    return x[..., :last].reshape(shape)


def _moment_init(p: torch.Tensor, dtype: str):
    """Zeros; an int8 moment is the quantization of zeros (q 0, s 0)."""
    if dtype == "int8":
        lead = tuple(p.shape[:-1]) if p.dim() else ()
        nb = -(-(p.shape[-1] if p.dim() else 1) // QBLOCK)
        return {"q": torch.zeros(lead + (nb, QBLOCK), dtype=torch.int8,
                                 device=p.device),
                "s": torch.zeros(lead + (nb, 1), dtype=torch.float32,
                                 device=p.device)}
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# ---------------------------------------------------------------------------
# trees: nested dicts and lists, leaves in the reference's order
# ---------------------------------------------------------------------------

def as_tree(params) -> Any:
    """A ``ParamTree`` as its dict/list tree; a tree as it is."""
    return params.tree() if isinstance(params, torch.nn.Module) else params


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def walk(tree, *others) -> Iterator[tuple]:
    """``(leaf, *the others' nodes at its place)`` in JAX's leaf order
    (dict keys sorted): the reference's ``flatten_up_to``.  A ``None``
    other stays ``None`` below."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], *(None if o is None else o[k]
                                       for o in others))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, *(None if o is None else o[i]
                                 for o in others))
    else:
        yield (tree, *others)


def _rows(x, last: int):
    """A view of ``x`` (or of an int8 moment's ``q`` and ``s``) with its
    leading dims flattened into rows of the leaf's ``last`` dim: a view,
    so that writes land in ``x``."""
    if isinstance(x, dict):
        return {k: v.view(-1, *v.shape[-2:]) for k, v in x.items()}
    return x.view(-1, last)


def _slices(p: torch.Tensor) -> list:
    """Index expressions covering ``p`` (rows of its last dim, as
    ``_rows`` lays it out) about ``SLICE_ELEMS`` elements at a time; the
    whole leaf below 2 dims, where dim 0 is the block dim."""
    if p.dim() < 2:
        return [...]
    rows = max(1, SLICE_ELEMS // max(1, p.shape[-1]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def init_opt_state(params, cfg: OptConfig) -> dict:
    tree = as_tree(params)
    state = {
        "step": torch.zeros((), dtype=torch.int32,
                            device=next(walk(tree))[0].device),
        "m": tree_map(lambda p: _moment_init(p, cfg.moment_dtype), tree),
        "v": tree_map(lambda p: _moment_init(p, cfg.moment_dtype), tree),
    }
    if cfg.grad_quant_bits:
        state["err"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), tree)
    return state


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares, leaf by leaf in the reference's
    order (a missing leaf counts zero)."""
    total = None
    for (x,) in walk(tree):
        if x is None:
            continue
        if x.dim() >= 2:
            x = x.reshape(-1, x.shape[-1])
        for sl in _slices(x):
            c = x[sl].to(torch.float32)
            part = torch.sum(c * c)
            total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step, in place.  ``grads`` follows the parameters'
    dict/list tree; a ``None`` leaf is a zero gradient (JAX gives an
    unused leaf zeros, and the leaf still decays).  Returns ``(params,
    state, {"lr", "grad_norm"})``, the same objects written."""
    from repro_torch.optim.compress import feedback

    state["step"].add_(1)
    step = state["step"].to(torch.float32)
    lr = schedule(cfg, state["step"])
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                       max=1.0)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    decay = 1 - lr * cfg.weight_decay
    err = state.get("err") if cfg.grad_quant_bits else None

    for p, g, m, v, e in walk(as_tree(params), grads, state["m"],
                              state["v"], err):
        if p.dim() >= 2:
            last = p.shape[-1]
            p, m, v = _rows(p, last), _rows(m, last), _rows(v, last)
            g = None if g is None else g.reshape(-1, last)
            e = None if e is None else _rows(e, last)
        for sl in _slices(p):
            pc = p[sl]
            gc = (g[sl].to(torch.float32) if g is not None
                  else torch.zeros(pc.shape, dtype=torch.float32,
                                   device=pc.device))
            if e is not None:
                gc, new_e = feedback(gc, e[sl], cfg.grad_quant_bits)
                e[sl] = new_e
            gc = gc * clip
            mf = _moment_get(m, sl, pc.shape)
            vf = _moment_get(v, sl, pc.shape)
            mf = cfg.b1 * mf + (1 - cfg.b1) * gc
            vf = cfg.b2 * vf + (1 - cfg.b2) * gc * gc
            mhat = mf / bc1
            vhat = vf / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            pc.copy_((pc.to(torch.float32) * decay - lr * delta)
                     .to(p.dtype))
            _moment_set(m, sl, mf)
            _moment_set(v, sl, vf)
    return params, state, {"lr": lr, "grad_norm": gnorm}


def _moment_get(m, sl, shape) -> torch.Tensor:
    if isinstance(m, dict):
        return _dequant(m["q"][sl], m["s"][sl], shape)
    return m[sl]


def _moment_set(m, sl, val: torch.Tensor) -> None:
    if isinstance(m, dict):
        q, s = _quant(val)
        m["q"][sl] = q
        m["s"][sl] = s
    else:
        m[sl] = val
