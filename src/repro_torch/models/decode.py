"""Single-token decode (``serve_step``), bulk prefill and slot-cache ops,
DENSE and MOE families (port of ``repro.models.decode``).

The cache is ``{'k': [L, B, S, KV, dh], 'v': ...}`` for both.  Unlike the
reference, whose arrays are immutable, ``serve_step`` and the slot ops
update the cache in place (one cache per serving lane, no copies per
step) and return the same dict.  The batch dimension holds fixed *slots*
that requests are admitted into and evicted from.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ApproxConfig, ModelConfig
from repro_torch.core.approx_linear import dense
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.transformer import (
    Transformer,
    apply_model,
    check_family,
    layer_calibration,
)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> Dict[str, Any]:
    check_family(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    dtype = getattr(torch, cfg.compute_dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _attn_decode_block(x, p, cfg, ctx, ck, cv, pos, flash=False):
    h = L.decode_attention(
        L.rmsnorm(x, p.ln1, cfg.norm_eps), p.attn, cfg, ctx, ck, cv, pos, flash=flash
    )
    x = x + h
    if cfg.n_experts:
        f, _ = M.moe_ffn(L.rmsnorm(x, p.ln2, cfg.norm_eps), p.moe, cfg, ctx)
    else:
        f = L.mlp(L.rmsnorm(x, p.ln2, cfg.norm_eps), p.mlp, ctx)
    return x + f


def serve_step(
    params: Transformer,
    cache: Dict[str, Any],
    tokens,
    pos,
    cfg: ModelConfig,
    *,
    ctx=None,
    calib=None,
    flash: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: [B, 1] int; pos: int (index being written) or [B] int32
    per-row positions.  ``ctx`` (an ``ApproxCtx`` in MODEL mode) serves
    bit-accurate emulated logits; its key path serves every layer and the
    LM head alike (decode keeps one key per step, as in the reference).
    A ctx with a ``[B, n_sites]`` ``site_idx`` serves each row on its own
    backend map (the engine's merged lanes).
    ``calib`` (a calibration tree, laid out as ``init_calibration``) gives
    each layer and the head its sites: with ``ctx.correct`` the fitted mean
    error is subtracted, how the engine serves a recalibrated chip.  Every
    layer's ctx shares the step's memo, so each site still draws and builds
    its SC tables, and recombines the chip's terms, once a step; so does
    each expert site of a MoE model (its sub-contexts share the memo).
    A MoE step routes every row, idle slots included: they take expert
    capacity, as in the reference.
    ``flash`` takes the decode attention kernel.  Returns (logits
    [B, vocab], cache updated in place)."""
    check_family(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    threaded = ctx is not None and calib is not None
    x = params.embed[tokens].to(dtype)  # [B, 1, D]
    for l, p in enumerate(params.layers):
        lctx = ctx.with_calib(layer_calibration(calib, l)) if threaded else ctx
        x = _attn_decode_block(x, p, cfg, lctx, cache["k"][l], cache["v"][l], pos, flash)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    hctx = ctx.with_calib(calib["head"]) if threaded else ctx
    logits = dense(x[:, 0], w.to(dtype), site="lm_head", ctx=hctx)
    if logits.shape[-1] != cfg.vocab_size:  # drop vocab-padding columns
        logits = logits[..., : cfg.vocab_size]
    return logits, cache


def slot_insert(cfg: ModelConfig, cache, sub, slot: int):
    """Write a k-slot sub-cache into ``cache`` from slot index ``slot``
    (in place).  Every row is fully overwritten, so a freed slot needs no
    reset before reuse."""
    for key in ("k", "v"):
        n = sub[key].shape[1]
        cache[key][:, slot : slot + n] = sub[key].to(cache[key].dtype)
    return cache


def slot_extract(cfg: ModelConfig, cache, slot: int, k: int = 1):
    """A copy of the k-slot sub-cache starting at slot index ``slot``."""
    return {key: cache[key][:, slot : slot + k].clone() for key in ("k", "v")}


def slot_reset(cfg: ModelConfig, cache, slot: int, k: int = 1):
    """Zero a slot (eviction), in place."""
    for key in ("k", "v"):
        cache[key][:, slot : slot + k].zero_()
    return cache


def pad_cache_to(cfg: ModelConfig, cache, max_seq: int):
    """Right-pad the sequence axis of a cache to ``max_seq`` with zeros.
    Rows past a slot's position are never attended: decode masks
    ``index > pos`` and writes ``pos`` before reading it."""
    out = {}
    for key, leaf in cache.items():
        extra = max_seq - leaf.shape[2]
        out[key] = F.pad(leaf, (0, 0, 0, 0, 0, extra)) if extra else leaf
    return out


def prefill(
    params: Transformer,
    tokens,
    cfg: ModelConfig,
    *,
    lengths=None,
    max_seq: Optional[int] = None,
    approx: Optional[ApproxConfig] = None,
    chunk_q: int = 1024,
    rng=None,
    draws=None,
    calib=None,
    chip=None,
    correct: bool = False,
    backend_idx=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Bulk prefill: one full-sequence forward over ``tokens [B, L]``.

    ``lengths`` ([B], default L) marks true prompt lengths of right-padded
    rows; the returned logits are taken at ``lengths - 1``.  Returns
    ``(last_logits [B, vocab], cache)``, the cache padded to ``max_seq``
    when given.  ``approx`` with ``mode=MODEL`` prefills with bit-accurate
    emulation (composed path, as in the reference); ``rng``, ``draws``,
    ``calib``, ``chip``, ``correct`` and ``backend_idx`` go to
    :func:`repro_torch.models.transformer.apply_model`: a chip-bound lane
    prefills on its chip, with its correction, and a merged lane on the
    request's ``[n_sites]`` index vector.
    """
    B, T = tokens.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int64, device=tokens.device)
    lengths = torch.as_tensor(lengths, device=tokens.device).long()
    out = apply_model(
        params, {"tokens": tokens}, cfg,
        approx=approx if approx is not None else ApproxConfig(),
        chunk_q=chunk_q, return_cache=True, rng=rng, draws=draws, calib=calib, chip=chip,
        correct=correct, backend_idx=backend_idx,
    )
    last = out.logits[torch.arange(B, device=tokens.device), lengths - 1]
    cache = out.cache
    if max_seq is not None:
        cache = pad_cache_to(cfg, cache, max_seq)
    return last, cache
