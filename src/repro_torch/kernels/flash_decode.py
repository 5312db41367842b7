"""Single-token decode attention (port of ``repro.kernels.flash_decode``):
kernel K3 (``csrc/flash_decode.cu``) and its plain version.

Equivalence of the two is allclose, not bitwise: the kernel's online
softmax reassociates the normaliser sum.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# outputs a block of the kernel holds: a group of G query heads with
# G * dh above it is split across blocks of at most 2048 // dh heads
MAX_BLOCK_OUTPUTS = 2048


def flash_decode(q, cache_k, cache_v, pos_vec):
    """q: [B, KV, G, dh]; cache_k/v: [B, S, KV, dh]; pos_vec: [B] int32.

    Returns [B, KV, G, dh] float32: each row attends to cache positions
    0..pos_vec[b] inclusive.
    """
    B, KV, G, dh = q.shape
    S = cache_k.shape[1]
    dev = q.device
    if dev.type != "cuda" or cache_k.device != dev or cache_v.device != dev:
        raise ValueError("flash_decode kernel needs q and the caches on one CUDA device")
    if not (q.dtype == cache_k.dtype == cache_v.dtype) or q.dtype not in (
        torch.float32, torch.bfloat16
    ):
        raise ValueError(f"q and caches must share float32 or bfloat16; got {q.dtype}")
    if cache_k.shape != (B, S, KV, dh) or cache_v.shape != cache_k.shape:
        raise ValueError(f"caches must be [B,S,KV,dh]={B, S, KV, dh}")
    if not (q.is_contiguous() and cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("q and caches must be contiguous")
    if dh > MAX_BLOCK_OUTPUTS:
        raise ValueError(f"flash_decode kernel holds dh <= {MAX_BLOCK_OUTPUTS}; got {dh}")
    pos = pos_vec.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B, KV, G, dh), dtype=torch.float32, device=dev)
    build.launch(
        "flash_decode", "flash_decode", "flash_decode",
        int(q.dtype == torch.bfloat16), q.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, S, KV, G, dh, dh ** -0.5, torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


def flash_decode_ref(q, cache_k, cache_v, pos_vec):
    """Plain version: the einsum/mask/softmax block the kernel replaces
    (full-S logits materialised)."""
    dh = q.shape[-1]
    S = cache_k.shape[1]
    logits = torch.einsum(
        "bkgd,btkd->bkgt", q.to(torch.float32), cache_k.to(torch.float32)
    ) * (dh ** -0.5)
    mask = torch.arange(S, device=q.device)[None, :] <= pos_vec[:, None]  # [B, S]
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", probs, cache_v.to(torch.float32))
