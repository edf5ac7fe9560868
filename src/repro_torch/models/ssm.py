"""Mamba2 SSD (state-space duality) block — chunked scan, arXiv:2405.21060.

PyTorch port of ``repro.models.ssm``.  Prefill: the sequence is split into
chunks; the intra-chunk term is a masked quadratic (attention-like) product,
the inter-chunk term a loop over chunk states — linear in sequence length.
Decode: O(1) per token via the carried (B, nh, hd, N) state + conv tail.
The intra-chunk decay is masked to -inf above the diagonal before its
``exp``, where the reference masks after it: the forward is the same bit
for bit, and the backward stays finite over a 128-token chunk, where the
reference's overflows to 0 * inf = NaN (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_leaf, rms_norm


class MambaParams(NamedTuple):
    in_proj: torch.Tensor   # (D, 2*di + 2*N + nh)
    conv_w: torch.Tensor    # (W, di + 2*N) depthwise causal conv
    A_log: torch.Tensor     # (nh,)
    D_skip: torch.Tensor    # (nh,)
    dt_bias: torch.Tensor   # (nh,)
    ssm_norm: torch.Tensor  # (di,)
    out_proj: torch.Tensor  # (di, D)


class MambaState(NamedTuple):
    h: torch.Tensor         # (B, nh, hd, N) SSM state
    conv: torch.Tensor      # (B, W-1, di + 2*N) conv tail


def _dims(cfg: ModelConfig):
    sc = cfg.ssm
    di = sc.expand * cfg.d_model
    nh = di // sc.head_dim
    return di, nh, sc.state_dim, sc.conv_width, sc.head_dim


def mamba_shapes(cfg: ModelConfig) -> dict:
    """Each parameter's (shape, init, dtype or None for the model's), for
    ``layers.init_leaf``."""
    di, nh, n, w, _ = _dims(cfg)
    f32 = torch.float32
    return {"in_proj": ((cfg.d_model, 2 * di + 2 * n + nh), None, None),
            "conv_w": ((w, di + 2 * n), 0.5, None),
            "A_log": ((nh,), "zeros", f32),          # A = -exp(0) = -1
            "D_skip": ((nh,), "ones", f32),
            "dt_bias": ((nh,), "zeros", f32),
            "ssm_norm": ((di,), "zeros", None),
            "out_proj": ((di, cfg.d_model), None, None)}


def init_mamba(cfg: ModelConfig, dtype: torch.dtype, *,
               generator: torch.Generator | None = None,
               device=None) -> MambaParams:
    return MambaParams(**{
        k: init_leaf(shape, init, dt or dtype, generator=generator,
                     device=device)
        for k, (shape, init, dt) in mamba_shapes(cfg).items()})


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, nh, n, _, _ = _dims(cfg)
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, nh], dim=-1)
    return z, xbc, dt  # (…, di), (…, di+2N), (…, nh)


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  xbc: (B, S, C); conv_w: (W, C)."""
    w = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(w):  # W is tiny (4): unrolled taps
        out = out + pad[:, i:i + xbc.shape[1], :] * conv_w[i]
    return F.silu(out)


def ssd_scan(x, dt, a_log, bmat, cmat, chunk: int):
    """Chunked SSD.  x: (B,S,nh,hd); dt: (B,S,nh); bmat/cmat: (B,S,N).

    Returns (y, final_state) with y: (B,S,nh,hd), state: (B,nh,hd,N).
    """
    b, s, nh, hd = x.shape
    n = bmat.shape[-1]
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"sequence {s} is not a multiple of the SSD chunk "
                         f"{l}")
    nc = s // l
    a = -torch.exp(a_log.float())                       # (nh,) negative
    la = dt.float() * a                                 # (B,S,nh) log-decay

    xc = x.reshape(b, nc, l, nh, hd).float()
    dtc = dt.reshape(b, nc, l, nh).float()
    lac = la.reshape(b, nc, l, nh)
    bc = bmat.reshape(b, nc, l, n).float()
    cc = cmat.reshape(b, nc, l, n).float()

    cum = torch.cumsum(lac, dim=2)                      # (B,nc,L,nh)
    seg_total = cum[:, :, -1, :]                        # (B,nc,nh)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))

    h = torch.zeros((b, nh, hd, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xk, dtk, cumk = xc[:, c], dtc[:, c], cum[:, c]
        bk, ck, totk = bc[:, c], cc[:, c], seg_total[:, c]
        # intra-chunk (quadratic within L):
        # T[b,h,i,j] = (C_i·B_j) * exp(cum_i - cum_j) * dt_j   (i >= j)
        cb = torch.einsum("bin,bjn->bij", ck, bk)          # (B,L,L)
        dec = cumk[:, :, None, :] - cumk[:, None, :, :]    # (B,L,L,nh)
        # above the diagonal dec is a growing sum of -dt*a > 0 and its exp
        # overflows over a 128-token chunk; -inf there keeps the forward
        # bit for bit and the backward finite (the reference's masked inf
        # gives 0 * inf = NaN gradients: ROADMAP Queue 3)
        dec = torch.where(mask[None, :, :, None], dec, float("-inf"))
        t = torch.where(mask[None, :, :, None],
                        cb[..., None] * torch.exp(dec) * dtk[:, None, :, :],
                        0.0)
        y_intra = torch.einsum("bijh,bjhd->bihd", t, xk)
        # inter-chunk: contribution of the entering state
        y_inter = torch.einsum("bin,bhdn,bih->bihd", ck, h, torch.exp(cumk))
        # state update: h' = exp(total) h + sum_j exp(total-cum_j) dt_j x_j B_j^T
        w = torch.exp(totk[:, None, :] - cumk) * dtk       # (B,L,nh)
        s_new = torch.einsum("bjh,bjhd,bjn->bhdn", w, xk, bk)
        h = torch.exp(totk)[:, :, None, None] * h + s_new
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, nh, hd)
    return y, h


def mamba_forward(p: MambaParams, cfg: ModelConfig, x: torch.Tensor
                  ) -> tuple[torch.Tensor, MambaState]:
    """Full-sequence forward.  x: (B, S, D) -> (y, final_state)."""
    di, nh, n, w, hd = _dims(cfg)
    b, s, _ = x.shape
    z, xbc, dt = _split_proj(cfg, x @ p.in_proj)
    conv_tail = xbc[:, max(0, s - (w - 1)):, :]
    pad_t = (w - 1) - conv_tail.shape[1]
    conv_tail = F.pad(conv_tail, (0, 0, pad_t, 0))
    xbc = _causal_conv(xbc, p.conv_w)
    xin, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    dt_s = F.softplus(dt.float() + p.dt_bias)
    y, h = ssd_scan(xin.reshape(b, s, nh, hd), dt_s, p.A_log, bmat, cmat,
                    cfg.ssm.chunk)
    y = y + p.D_skip[None, None, :, None] * xin.reshape(b, s, nh, hd).float()
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.ssm_norm, cfg.norm_eps)
    return y @ p.out_proj, MambaState(h, conv_tail)


def init_mamba_state(batch: int, cfg: ModelConfig, dtype,
                     device=None) -> MambaState:
    di, nh, n, w, hd = _dims(cfg)
    return MambaState(
        h=torch.zeros((batch, nh, hd, n), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, w - 1, di + 2 * n), dtype=dtype,
                         device=device),
    )


def mamba_decode(p: MambaParams, cfg: ModelConfig, x: torch.Tensor,
                 state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """One-token decode.  x: (B, 1, D).  Returns a new state."""
    di, nh, n, w, hd = _dims(cfg)
    b = x.shape[0]
    z, xbc, dt = _split_proj(cfg, x[:, 0, :] @ p.in_proj)  # (B, …)
    window = torch.cat([state.conv, xbc[:, None, :]], dim=1)  # (B,W,C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p.conv_w))
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)
    dt_s = F.softplus(dt.float() + p.dt_bias)                   # (B, nh)
    a = -torch.exp(p.A_log.float())
    decay = torch.exp(dt_s * a)                                 # (B, nh)
    xh = xin.reshape(b, nh, hd).float()
    h = (state.h * decay[:, :, None, None] +
         torch.einsum("bh,bhd,bn->bhdn", dt_s, xh, bmat.float()))
    y = torch.einsum("bn,bhdn->bhd", cmat.float(), h)
    y = y + p.D_skip[None, :, None] * xh
    y = y.reshape(b, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.ssm_norm, cfg.norm_eps)
    return (y @ p.out_proj)[:, None, :], MambaState(h, window[:, 1:, :])
