"""Single-token decode (``serve_step``), bulk prefill and slot-cache ops,
every ported family (port of ``repro.models.decode``).

Caches, stacked as the parameters are:

* DENSE, MOE: ``{'k': [L, B, S, KV, dh], 'v': ...}``
* SSM:        ``{'state': [L, B, H, N, P] float32, 'conv': [L, B, W-1, C]}``
* HYBRID:     ``{'mamba': {'state': [G, k, B, ...], 'conv': ...}, 'tail':
  {...: [t, B, ...]}, 'shared': {'k': [G, B, S, KV, dh], 'v': ...}}``

Unlike the reference, whose arrays are immutable, ``serve_step`` and the
slot ops update the cache in place (one cache per serving lane, no copies
per step) and return the same dict.  The batch dimension holds fixed
*slots* that requests are admitted into and evicted from; the slot (and
sequence) axis of each leaf is found as the reference finds it
(:func:`cache_axes`).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ApproxConfig, Family, ModelConfig
from repro_torch.core.approx_linear import dense
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.transformer import (
    Transformer,
    apply_model,
    check_family,
    hybrid_layout,
    layer_calibration,
)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of trees of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stacked(tree, lead: Tuple[int, ...]):
    return _tree_map(lambda t: t.expand(lead + t.shape).clone(), tree)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> Dict[str, Any]:
    check_family(cfg)
    dtype = getattr(torch, cfg.compute_dtype)

    def kv(n_outer):
        shape = (n_outer, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    if cfg.family == Family.SSM:
        return _stacked(S.init_ssm_cache(cfg, batch, dtype, device), (cfg.n_layers,))
    if cfg.family == Family.HYBRID:
        G, k, tail = hybrid_layout(cfg)
        one = S.init_ssm_cache(cfg, batch, dtype, device)
        cache = {"mamba": _stacked(one, (G, k)), "shared": kv(G)}
        if tail:
            cache["tail"] = _stacked(one, (tail,))
        return cache
    return kv(cfg.n_layers)


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


def _mamba_decode_block(x, p: S.SSMBlock, cfg, ctx, cache):
    return x + S.ssm_decode_step(L.rmsnorm(x, p.ln1, cfg.norm_eps), p.ssm, cfg, ctx, cache)


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
    each expert site of a MoE model (its sub-contexts share the memo), and
    so do a HYBRID model's shared block's sites, which recur once a group.
    A MoE step routes every row, idle slots included: they take expert
    capacity, as in the reference.  An SSM row's state advances every
    step, an idle slot's too, as in the reference.
    ``flash`` takes the decode attention kernel.  Returns (logits
    [B, vocab], cache updated in place)."""
    check_family(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    threaded = ctx is not None and calib is not None

    def lctx(part, i, j=None):
        return ctx.with_calib(layer_calibration(calib, i, part, j)) if threaded else ctx

    x = params.embed[tokens].to(dtype)  # [B, 1, D]
    if cfg.family == Family.SSM:
        for l, p in enumerate(params.layers):
            x = _mamba_decode_block(x, p, cfg, lctx("layers", l), M.index_tree(cache, l))
    elif cfg.family == Family.HYBRID:
        for g, group in enumerate(params.layers):
            for j, p in enumerate(group):
                x = _mamba_decode_block(x, p, cfg, lctx("layers", g, j),
                                        M.index_tree(M.index_tree(cache["mamba"], g), j))
            x = _attn_decode_block(x, params.shared, cfg, lctx("shared", g),
                                   cache["shared"]["k"][g], cache["shared"]["v"][g], pos, flash)
        for j, p in enumerate(params.tail or ()):
            x = _mamba_decode_block(x, p, cfg, lctx("tail", j), M.index_tree(cache["tail"], j))
    else:
        for l, p in enumerate(params.layers):
            x = _attn_decode_block(x, p, cfg, lctx("layers", l), cache["k"][l], cache["v"][l],
                                   pos, flash)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    hctx = ctx.with_calib(calib["head"]) if threaded else ctx
    logits = dense(x[:, 0], w.to(dtype), site="lm_head", ctx=hctx)
    if logits.shape[-1] != cfg.vocab_size:  # drop vocab-padding columns
        logits = logits[..., : cfg.vocab_size]
    return logits, cache


def _diff_axis(a, b) -> int:
    """The one axis where two shapes differ; -1 where they agree."""
    diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
    if not diffs:
        return -1
    assert len(diffs) == 1, f"ambiguous axis diff: {a.shape} vs {b.shape}"
    return diffs[0]


@functools.lru_cache(maxsize=None)
def cache_axes(cfg: ModelConfig):
    """(slot axes, sequence axes): trees matched to the cache, each leaf the
    axis index of its slot (batch) dim and of its sequence dim (-1 for a
    leaf without one, an SSM state), found as the reference finds them: by
    diffing the shapes of caches that differ only in batch or ``max_seq``
    (made on the meta device: no memory)."""
    a, b, c = (init_cache(cfg, n, s, "meta") for n, s in ((2, 5), (3, 5), (2, 7)))
    return _tree_map(_diff_axis, a, b), _tree_map(_diff_axis, a, c)


def slot_insert(cfg: ModelConfig, cache, sub, slot: int):
    """Write a k-slot sub-cache into ``cache`` from slot index ``slot``
    (in place).  Every leaf is fully overwritten along its other axes, so a
    freed slot needs no reset before reuse."""
    def put(c, s, ax):
        c.narrow(ax, slot, s.shape[ax]).copy_(s)

    _tree_map(put, cache, sub, cache_axes(cfg)[0])
    return cache


def slot_extract(cfg: ModelConfig, cache, slot: int, k: int = 1):
    """A copy of the k-slot sub-cache starting at slot index ``slot``."""
    return _tree_map(lambda c, ax: c.narrow(ax, slot, k).clone(), cache, cache_axes(cfg)[0])


def slot_reset(cfg: ModelConfig, cache, slot: int, k: int = 1):
    """Zero a slot (eviction), in place."""
    _tree_map(lambda c, ax: c.narrow(ax, slot, k).zero_(), cache, cache_axes(cfg)[0])
    return cache


def pad_cache_to(cfg: ModelConfig, cache, max_seq: int):
    """Right-pad every sequence axis of a cache to ``max_seq`` with zeros.
    Rows past a slot's position are never attended: decode masks
    ``index > pos`` and writes ``pos`` before reading it."""
    def pad(leaf, ax):
        if ax < 0 or leaf.shape[ax] == max_seq:
            return leaf
        widths = [0, 0] * (leaf.dim() - ax - 1) + [0, max_seq - leaf.shape[ax]]
        return F.pad(leaf, widths)

    return _tree_map(pad, cache, cache_axes(cfg)[1])


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
    rows: SSM recurrences stand still past each row's length, and the
    returned logits are taken at ``lengths - 1``.  Returns
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
        correct=correct, backend_idx=backend_idx, seq_lens=lengths,
    )
    last = out.logits[torch.arange(B, device=tokens.device), lengths - 1]
    cache = out.cache
    if max_seq is not None:
        cache = pad_cache_to(cfg, cache, max_seq)
    return last, cache
