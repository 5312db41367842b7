"""Mamba-2 block: SSD (state-space duality) with the chunked algorithm (port
of ``repro.models.ssm``: ``_dims``, ``_dt_pad``, ``init_ssm``,
``_causal_conv``, ``_ssd_chunked``, ``ssm_block`` with ``mask`` and
``return_cache``, ``init_ssm_cache`` and ``ssm_decode_step``).

Prefill runs the SSD chunked dual form: the sequence is split into chunks,
intra-chunk terms are masked attention-like contractions, inter-chunk
terms a short loop over chunk states.  Decode is the O(1) recurrence on the
``[B, H, N, P]`` state.

The in and out projections go through ``dense`` (sites ``ssm_in`` and
``ssm_out``), and so through the emulation kernels.  The SSD recurrence and
the depthwise conv have no long dot product for an emulator to act on, and
the reference has no Pallas kernel for them: they are plain torch ops, as
the port's norms, RoPE and prefill attention are.
"""
from __future__ import annotations

import concurrent.futures
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx_linear import ApproxCtx, dense
from repro_torch.models import layers as L

SSM_SITES = ("ssm_in", "ssm_out")


class SSM(nn.Module):
    """One Mamba-2 mixer in the reference's layout: ``in_proj`` [D, 2 d_in
    + 2 N + H (+ dt padding)] and ``out_proj`` [d_in, D], ``conv_w`` [W, C]
    and ``conv_b`` [C] (C = d_in + 2 N) and ``norm_w`` [d_in] in the
    parameter dtype; ``A_log``, ``D_skip`` and ``dt_bias`` [H] float32."""

    def __init__(self, in_proj, conv_w, conv_b, A_log, D_skip, dt_bias, norm_w, out_proj):
        super().__init__()
        (self.in_proj, self.conv_w, self.conv_b, self.A_log, self.D_skip, self.dt_bias,
         self.norm_w, self.out_proj) = map(
            L.frozen, (in_proj, conv_w, conv_b, A_log, D_skip, dt_bias, norm_w, out_proj))


class SSMBlock(nn.Module):
    """``ln1`` and the mixer ``ssm``: ``x + ssm(rmsnorm(x))``."""

    def __init__(self, ln1, ssm: SSM):
        super().__init__()
        self.ln1 = L.frozen(ln1)
        self.ssm = ssm


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_d_inner
    H = cfg.ssm_n_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_ch = d_in + 2 * N  # conv over (x, B, C)
    return d_in, H, P, N, conv_ch


def _dt_pad(H: int) -> int:
    """Dead dt columns that widen ``in_proj`` to a 32-multiple when
    REPRO_SSM_PAD=1, as in the reference (a sharding knob there); the
    mixer reads dt as the first H columns of its block either way."""
    if os.environ.get("REPRO_SSM_PAD") == "1":
        return (-H) % 32
    return 0


def _a_log(H: int) -> torch.Tensor:
    """``log(jnp.linspace(1, 16, H))`` in float32, op for op as
    ``jnp.linspace`` computes it (``start * (1 - s) + stop * s``, s = i /
    (H - 1), the last entry ``stop`` itself)."""
    if H == 1:
        out = torch.ones((1,), dtype=torch.float32)
    else:
        step = torch.arange(H - 1, dtype=torch.float32) / torch.tensor(float(H - 1))
        out = torch.cat([1.0 * (1 - step) + 16.0 * step, torch.tensor([16.0])])
    return torch.log(out)


def _layer_seed(seed: int, layer: int, tensor: int) -> int:
    return int(np.random.SeedSequence([seed, layer, tensor]).generate_state(1, np.uint64)[0])


def init_ssm_blocks(cfg: ModelConfig, dtype, device, seed: int,
                    layers: Sequence[int]) -> List[SSMBlock]:
    """SSM blocks for the model's layers ``layers`` (global indices): the
    three random tensors of each (``in_proj``, ``conv_w``, ``out_proj``)
    from a CPU generator of their own, seeded from ``(seed, layer,
    tensor)``, drawn in a thread pool and written into their tensors on
    ``device``; scaled as the reference's (``d ** -0.5``, 0.3, ``d_in **
    -0.5``).  ``conv_b`` and ``dt_bias`` zero, ``D_skip`` and the norms
    one, ``A_log = log(linspace(1, 16, H))``.  One seed gives the same
    weights on every device."""
    d = cfg.d_model
    d_in, H, P, N, conv_ch = _dims(cfg)
    shapes = ((d, 2 * d_in + 2 * N + H + _dt_pad(H)), (cfg.ssm_conv_width, conv_ch), (d_in, d))
    scales = (d ** -0.5, 0.3, d_in ** -0.5)
    f32 = dict(dtype=torch.float32, device=device)
    a_log = _a_log(H).to(device)
    blocks, drawn = [], []
    for _ in layers:
        rnd = [torch.empty(s, dtype=dtype, device=device) for s in shapes]
        drawn.append(rnd)
        blocks.append(SSMBlock(torch.ones((d,), dtype=dtype, device=device), SSM(
            rnd[0], rnd[1], torch.zeros((conv_ch,), dtype=dtype, device=device),
            a_log.clone(), torch.ones((H,), **f32), torch.zeros((H,), **f32),
            torch.ones((d_in,), dtype=dtype, device=device), rnd[2])))

    def draw(job):
        i, t = job
        g = torch.Generator()
        g.manual_seed(_layer_seed(seed, layers[i], t))
        with torch.no_grad():
            drawn[i][t].copy_(torch.randn(shapes[t], generator=g, dtype=dtype) * scales[t])

    jobs = [(i, t) for i in range(len(layers)) for t in range(3)]
    if jobs:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(len(jobs), os.cpu_count() or 1)) as pool:
            list(pool.map(draw, jobs))
    return blocks


def _causal_conv(x, w, b):
    """Depthwise causal conv of width W: x [B, T, C], w [W, C] -> [B, T, C],
    the taps added in the reference's order."""
    W, T = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :T]
        out = out + shifted * w[-1 - i]
    return out + b


def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) + log1p(exp(
    -|x|))``, as jnp computes it."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD chunked dual.  x: [b, t, h, p]; dt: [b, t, h] (>= 0); A: [h]
    (negative); Bm, Cm: [b, t, n] (one group, shared by the heads).
    Returns (y [b, t, h, p] in x's dtype, the final state [b, h, n, p]
    float32).  One chunk returns its chunk state, as the reference's
    single-chunk branch does."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    T = t + pad
    nc = T // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    Bc = Bm.reshape(b, nc, chunk, n).to(f32)
    Cc = Cm.reshape(b, nc, chunk, n).to(f32)

    dA = dtc * A  # [b, c, l, h], negative
    dA_cum = torch.cumsum(dA, dim=2)
    dA_last = dA_cum[:, :, -1]  # [b, c, h]

    # intra-chunk (masked attention-like)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # [b, c, l, l]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    mask = mask[None, None, :, :, None]
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # [b, c, i, j, h]
    # the exponent is masked before exp: the i < j entries overflow, and
    # inf * 0 is NaN
    decay = torch.exp(torch.where(mask, seg, 0.0)) * mask
    M = CB[..., None] * decay
    M = M * dtc[:, :, None, :, :]  # weighted by dt at the source step j
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # chunk states
    state_decay = torch.exp(dA_last[:, :, None, :] - dA_cum)  # [b, c, l, h]
    S = torch.einsum("bcln,bclh,bclhp->bchnp", Bc, state_decay * dtc, xc)

    if nc == 1:
        y = y_diag.reshape(b, T, h, p)[:, :t]
        return y.to(x.dtype), S[:, 0]
    # inter-chunk recurrence: the carried state's share of each chunk
    carry = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    y_off = []
    for c in range(nc):
        y_off.append(torch.einsum("bln,blh,bhnp->blhp", Cc[:, c], torch.exp(dA_cum[:, c]),
                                  carry))
        carry = carry * torch.exp(dA_last[:, c])[..., None, None] + S[:, c]
    y = (y_diag + torch.stack(y_off, dim=1)).reshape(b, T, h, p)[:, :t]
    return y.to(x.dtype), carry


def _split_in(zxbcdt, cfg: ModelConfig):
    """z, x, B, C and dt (its first H columns) of the in projection."""
    d_in, H, P, N, _ = _dims(cfg)
    z, xr, Bm, Cm, dt = torch.split(
        zxbcdt, [d_in, d_in, N, N, zxbcdt.shape[-1] - 2 * d_in - 2 * N], dim=-1)
    return z, xr, Bm, Cm, dt[..., :H]


def ssm_block(x, p: SSM, cfg: ModelConfig, ctx: Optional[ApproxCtx], *, mask=None,
              return_cache: bool = False):
    """Full-sequence Mamba-2 mixer: x [B, T, D] -> [B, T, D].

    ``mask`` ([B, T], 1 for real tokens) serves a right-padded bulk
    prefill: dt is zeroed at padded positions, so the recurrence stands
    still there and the final state is the state at each row's length.
    With ``return_cache`` it also returns the decode cache ``{'state': [B,
    H, N, P] float32, 'conv': [B, W-1, C]}``, the conv window being the
    last W-1 pre-conv channel rows before each row's length, what
    :func:`ssm_decode_step` continues from."""
    B, T, _ = x.shape
    d_in, H, P, N, conv_ch = _dims(cfg)
    zxbcdt = dense(x, p.in_proj, site="ssm_in", ctx=ctx)
    z, xr, Bm, Cm, dt = _split_in(zxbcdt, cfg)
    xbc_raw = torch.cat([xr, Bm, Cm], dim=-1)
    xbc = F.silu(_causal_conv(xbc_raw, p.conv_w, p.conv_b).to(torch.float32)).to(x.dtype)
    xr, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)

    dt = softplus(dt.to(torch.float32) + p.dt_bias)  # [B, T, H]
    if mask is not None:
        dt = dt * mask.to(dt.dtype)[..., None]
    A = -torch.exp(p.A_log)  # [H]
    xh = xr.reshape(B, T, H, P)
    y, fstate = _ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + p.D_skip[:, None].to(y.dtype) * xh
    y = L.gated_rmsnorm(y.reshape(B, T, d_in), z, p.norm_w, cfg.norm_eps)
    out = dense(y, p.out_proj, site="ssm_out", ctx=ctx)
    if not return_cache:
        return out
    W = cfg.ssm_conv_width
    if mask is not None:
        lengths = mask.to(torch.int64).sum(dim=1)
    else:
        lengths = torch.full((B,), T, dtype=torch.int64, device=x.device)
    padded = F.pad(xbc_raw, (0, 0, W - 1, 0))
    rows = lengths[:, None] + torch.arange(W - 1, device=x.device)  # [B, W-1]
    window = padded[torch.arange(B, device=x.device)[:, None], rows]
    return out, {"state": fstate.to(torch.float32), "conv": window.to(x.dtype)}


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    d_in, H, P, N, conv_ch = _dims(cfg)
    return {
        "state": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def _conv_step(window, w, b):
    """``(window * w).sum(1) + b`` over the W taps of ``window`` [B, W, C],
    the sum rounded as XLA's: products in the operands' dtype, summed in
    float32, the sum rounded to it once."""
    prod = window * w
    return prod.to(torch.float32).sum(1).to(window.dtype) + b


def ssm_decode_step(x, p: SSM, cfg: ModelConfig, ctx, cache: Dict[str, torch.Tensor]):
    """One token: x [B, 1, D] -> [B, 1, D]; ``cache`` ``{'state': [B, H,
    N, P], 'conv': [B, W-1, C]}`` is updated in place."""
    B = x.shape[0]
    d_in, H, P, N, conv_ch = _dims(cfg)
    zxbcdt = dense(x[:, 0], p.in_proj, site="ssm_in", ctx=ctx)  # [B, ...]
    z, xr, Bm, Cm, dt = _split_in(zxbcdt, cfg)
    xbc = torch.cat([xr, Bm, Cm], dim=-1)  # [B, C]
    window = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # [B, W, C]
    conv_out = _conv_step(window, p.conv_w, p.conv_b)
    xbc = F.silu(conv_out.to(torch.float32)).to(x.dtype)
    xr, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)

    dt = softplus(dt.to(torch.float32) + p.dt_bias)  # [B, H]
    A = -torch.exp(p.A_log)
    dA = torch.exp(dt * A)  # [B, H]
    xh = xr.reshape(B, H, P).to(torch.float32)
    upd = (dt[:, :, None] * Bm.to(torch.float32)[:, None, :])[..., None] * xh[:, :, None, :]
    state = cache["state"] * dA[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm.to(torch.float32), state)
    y = y + p.D_skip[:, None] * xh
    y = L.gated_rmsnorm(y.reshape(B, d_in).to(x.dtype), z, p.norm_w, cfg.norm_eps)
    out = dense(y, p.out_proj, site="ssm_out", ctx=ctx)[:, None]
    cache["state"].copy_(state)
    cache["conv"].copy_(window[:, 1:])
    return out
