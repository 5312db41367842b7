"""Transformer layers: RMSNorm (and Mamba-2's gated RMSNorm), RoPE, GQA
attention, SwiGLU MLP (port of ``repro.models.layers``).

Weights keep the reference's ``[in, out]`` layout (``y = x @ w``), so
every projection goes through :func:`repro_torch.core.approx_linear.dense`
unchanged.  Prefill attention is plain torch ops, as it is plain XLA in
the reference; decode attention takes kernel K3 when ``flash`` is set.
"""
from __future__ import annotations

import concurrent.futures
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx_linear import ApproxCtx, dense
from repro_torch.kernels import ops as kops

NEG_INF = -1e30


def frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    """GQA projections; biases only for QKV-bias configs (qwen2.5)."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(frozen, (wq, wk, wv, wo))
        self.bq = None if bq is None else frozen(bq)
        self.bk = None if bk is None else frozen(bk)
        self.bv = None if bv is None else frozen(bv)


class MLP(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = map(frozen, (w_gate, w_up, w_down))


def rmsnorm(x, w, eps: float = 1e-5):
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.to(torch.float32)
    return out.to(dtype)


def gated_rmsnorm(x, gate, w, eps: float = 1e-5):
    """Mamba-2's ``rmsnorm(x * silu(gate))``: the silu in float32, cast
    back to x's dtype before the product."""
    return rmsnorm(x * F.silu(gate.to(torch.float32)).to(x.dtype), w, eps)


def rope(x, positions, theta: float):
    """x: [B, T, H, dh]; positions: [B, T] int."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# a tensor of at least this many elements is drawn in chunks of it, in parallel
NORMAL_CHUNK = 1 << 22


def _chunk_seed(base: int, i: int) -> int:
    return int(np.random.SeedSequence([base, i]).generate_state(1, np.uint64)[0])


def _normal(gen: torch.Generator, shape, scale, dtype, device):
    """Fan-in-scaled normals drawn from the CPU generator ``gen`` and scaled
    on the CPU, then moved to ``device``: the same weights on every device
    (the card's generator and libm would give others).  A tensor of
    ``NORMAL_CHUNK`` elements or more takes one draw of ``gen`` as a base
    seed, and its chunks of ``NORMAL_CHUNK`` come from CPU generators seeded
    from ``(base, chunk)``, drawn in a thread pool and written into their
    slices on ``device`` (a full-width ``init`` would take minutes of host
    time from one generator)."""
    n = math.prod(shape)
    if n < NORMAL_CHUNK:
        return (torch.randn(shape, generator=gen, dtype=dtype) * scale).to(device)
    base = int(torch.randint(0, 2**62, (1,), generator=gen))
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)

    def draw(i):
        g = torch.Generator()
        g.manual_seed(_chunk_seed(base, i))
        lo = i * NORMAL_CHUNK
        m = min(NORMAL_CHUNK, n - lo)
        flat[lo:lo + m].copy_(torch.randn((m,), generator=g, dtype=dtype) * scale)

    chunks = -(-n // NORMAL_CHUNK)
    with concurrent.futures.ThreadPoolExecutor(max_workers=min(chunks, os.cpu_count() or 1)) as pool:
        list(pool.map(draw, range(chunks)))
    return out


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Attention:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def normal(shape, scale):
        return _normal(gen, shape, scale, dtype, device)

    p = dict(
        wq=normal((d, h * dh), d ** -0.5),
        wk=normal((d, kv * dh), d ** -0.5),
        wv=normal((d, kv * dh), d ** -0.5),
        wo=normal((h * dh, d), (h * dh) ** -0.5),
    )
    if cfg.qkv_bias:
        for name, n in (("bq", h * dh), ("bk", kv * dh), ("bv", kv * dh)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return Attention(**p)


def _causal_attention(q, k, v, *, chunk_q: int):
    """q: [B, T, H, dh], k/v: [B, T, KV, dh] -> [B, T, H, dh].

    Query-chunked: each chunk of at most ``chunk_q`` queries attends over
    the full key length with a causal mask."""
    B, T, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    qg = q.reshape(B, T, KV, G, dh)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    k_pos = torch.arange(T, device=q.device)
    outs = []
    for q0 in range(0, T, chunk_q):
        qc = qg[:, q0 : q0 + chunk_q]
        C = qc.shape[1]
        logits = torch.einsum("bckgd,btkd->bkgct", qc.to(torch.float32), kf) * scale
        q_pos = q0 + torch.arange(C, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgct,btkd->bckgd", probs, vf)
        outs.append(out.reshape(B, C, H, dh).to(q.dtype))
    return torch.cat(outs, dim=1)


def attention(x, p: Attention, cfg: ModelConfig, ctx: Optional[ApproxCtx], positions,
              *, chunk_q: int = 1024):
    """Full-sequence (prefill) attention.  Returns (out, (k, v))."""
    B, T, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = dense(x, p.wq, p.bq, site="attn_q", ctx=ctx).reshape(B, T, H, dh)
    k = dense(x, p.wk, p.bk, site="attn_k", ctx=ctx).reshape(B, T, KV, dh)
    v = dense(x, p.wv, p.bv, site="attn_v", ctx=ctx).reshape(B, T, KV, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = _causal_attention(q, k, v, chunk_q=min(chunk_q, T))
    out = dense(out.reshape(B, T, H * dh), p.wo, site="attn_o", ctx=ctx)
    return out, (k, v)


def _update_rows(cache, update, pos_vec):
    """Write ``update [B, 1, KV, dh]`` into ``cache [B, S, KV, dh]`` at
    per-row positions ``pos_vec [B]``, in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos_vec.long()] = update[:, 0].to(cache.dtype)


def decode_attention(x, p: Attention, cfg: ModelConfig, ctx, cache_k, cache_v, pos,
                     *, flash: bool = False):
    """Single-token attention against a KV cache.

    x: [B, 1, D]; cache_k/v: [B, S, KV, dh], updated in place at each
    row's position; pos: int or [B] int32 per-row positions.  ``flash``
    takes the online-softmax kernel (:func:`repro_torch.kernels.ops.
    flash_decode_attention`); the einsum pair below is its plain version.
    Returns out [B, 1, D].
    """
    B = x.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    S = cache_k.shape[1]
    pos_vec = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(B)
    positions = pos_vec[:, None]
    q = dense(x, p.wq, p.bq, site="attn_q", ctx=ctx).reshape(B, 1, H, dh)
    k = dense(x, p.wk, p.bk, site="attn_k", ctx=ctx).reshape(B, 1, KV, dh)
    v = dense(x, p.wv, p.bv, site="attn_v", ctx=ctx).reshape(B, 1, KV, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    _update_rows(cache_k, k, pos_vec)
    _update_rows(cache_v, v, pos_vec)

    G = H // KV
    qg = q.reshape(B, KV, G, dh)
    if flash:
        out = kops.flash_decode_attention(qg, cache_k, cache_v, pos_vec)
    else:
        logits = torch.einsum(
            "bkgd,btkd->bkgt", qg.to(torch.float32), cache_k.to(torch.float32)
        ) * (dh ** -0.5)
        mask = torch.arange(S, device=x.device)[None, :] <= pos_vec[:, None]  # [B, S]
        logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgt,btkd->bkgd", probs, cache_v.to(torch.float32))
    out = out.reshape(B, 1, H * dh).to(x.dtype)
    return dense(out, p.wo, site="attn_o", ctx=ctx)


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> MLP:
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return _normal(gen, shape, scale, dtype, device)

    return MLP(
        w_gate=normal((d, f), d ** -0.5),
        w_up=normal((d, f), d ** -0.5),
        w_down=normal((f, d), f ** -0.5),
    )


def mlp(x, p: MLP, ctx: Optional[ApproxCtx]):
    g = dense(x, p.w_gate, site="mlp_gate", ctx=ctx)
    u = dense(x, p.w_up, site="mlp_up", ctx=ctx)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return dense(h, p.w_down, site="mlp_down", ctx=ctx)
