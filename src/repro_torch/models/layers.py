"""Shared neural layers: norms, RoPE, activations, dense FFN, init helpers.

PyTorch port of ``repro.models.layers``.  ``jax.nn.gelu`` defaults to the
tanh approximation, so GeGLU here calls ``F.gelu(approximate="tanh")``;
``rms_norm`` scales by ``1 + gain`` in float32 (not ``nn.RMSNorm``'s
``weight``), and ``rope`` rotates the two halves of the head (not
interleaved pairs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, gain: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + gain.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exponent)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(g: torch.Tensor, act: str) -> torch.Tensor:
    """SiLU for ``"swiglu"``, else JAX's default (tanh) GELU."""
    return F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")


def glu_ffn(x: torch.Tensor, w_in: torch.Tensor, w_gate: torch.Tensor,
            w_out: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU / GeGLU feed-forward."""
    h = x @ w_in
    g = activation(x @ w_gate, act)
    return (h * g) @ w_out


def dense_init(shape: tuple[int, ...], dtype: torch.dtype,
               scale: float | None = None, *,
               generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
    """Normal(0, 1) x ``scale`` (default fan_in^-0.5, fan_in = shape[-2]),
    drawn in float32 from ``generator`` on ``device`` and cast to ``dtype``.
    A leading stack dimension leaves fan_in as it is.  On the ``meta``
    device nothing is drawn."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    s = scale if scale is not None else fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    # drawn one leading slice at a time: the float32 transient stays one
    # slice (an expert stack is GBs)
    flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for i in range(flat.shape[0]):
        w = torch.randn(flat.shape[1:], generator=generator,
                        dtype=torch.float32, device=out.device)
        flat[i].copy_(w.mul_(s))
    return out


def init_leaf(shape: tuple[int, ...], init, dtype: torch.dtype, *,
              generator: torch.Generator | None = None,
              device=None) -> torch.Tensor:
    """One parameter: ``init`` is ``"zeros"``, ``"ones"``, or the scale of
    a ``dense_init`` (None: fan_in^-0.5)."""
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    return dense_init(shape, dtype, init, generator=generator, device=device)
