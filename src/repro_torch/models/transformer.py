"""Decoder-LM assembly, DENSE, MOE, SSM and HYBRID families (port of
``repro.models.transformer``: ``padded_vocab``, ``init_params``,
``hybrid_layout``, ``init_calibration``, ``_attn_block_apply``,
``_ssm_block_apply``, ``_embed``, ``_lm_head`` and ``apply_model`` with
``seq_lens``, ``return_cache``, ``calib``, ``collect``, ``remat``,
``chip``, ``correct``, ``calib_exact_ref``, ``blend``, ``backend_idx``
and ``bwd_gate``).

The parameters are an ``nn.Module`` tree (:class:`Transformer`); Python
loops over ``layers`` take the place of the reference's ``lax.scan``s.  A
HYBRID model (zamba2-style) keeps ``layers`` as G groups of k mamba
blocks, one ``shared`` attention+MLP block applied after each group, and
``tail`` (``n_layers % k`` mamba blocks after the last group).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ApproxConfig, Family, ModelConfig, TrainMode
from repro_torch.core import calibration as calib_lib
from repro_torch.core import checkpoint_policy
from repro_torch.core.approx_linear import ApproxCtx, dense
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

# the value the reference folds into the forward's key for the LM head
HEAD_FOLD = 2**20
ATTN_SITES = ("attn_q", "attn_k", "attn_v", "attn_o")
MLP_SITES = ("mlp_gate", "mlp_up", "mlp_down")
MOE_SITES = M.MOE_SITES
SSM_SITES = S.SSM_SITES
# every dense() call-site name across the reference's zoo: the universe
# that --site-backend patterns are checked against
ALL_SITES = ATTN_SITES + MLP_SITES + MOE_SITES + SSM_SITES + ("moe_router", "lm_head")


class Block(nn.Module):
    """One attention block with a SwiGLU ``mlp``, or for the MoE family
    an MoE FFN (``moe``) in its place."""

    def __init__(self, ln1, ln2, attn: L.Attention, mlp: Optional[L.MLP] = None,
                 moe: Optional[M.MoE] = None):
        super().__init__()
        self.ln1 = L.frozen(ln1)
        self.ln2 = L.frozen(ln2)
        self.attn = attn
        if moe is not None:
            self.moe = moe
        else:
            self.mlp = mlp


class Transformer(nn.Module):
    """Parameters of a decoder LM, in the reference's layouts: ``embed``
    [V, D], projections [in, out], ``lm_head`` [D, V] (absent for tied
    embeddings: the head reads ``embed`` in place, as the view
    ``embed.T``).  ``layers`` holds a :class:`Block` a layer (DENSE, MOE),
    an :class:`~repro_torch.models.ssm.SSMBlock` a layer (SSM), or G
    ``nn.ModuleList`` groups of k SSM blocks (HYBRID, with ``shared`` and
    ``tail``)."""

    def __init__(self, embed, final_norm, layers: List[nn.Module], lm_head=None,
                 shared: Optional[Block] = None, tail: Optional[List[S.SSMBlock]] = None):
        super().__init__()
        self.embed = L.frozen(embed)
        self.final_norm = L.frozen(final_norm)
        self.layers = nn.ModuleList(layers)
        self.lm_head = None if lm_head is None else L.frozen(lm_head)
        self.shared = shared
        self.tail = None if not tail else nn.ModuleList(tail)

    @property
    def device(self) -> torch.device:
        return self.embed.device


PORTED_FAMILIES = (Family.DENSE, Family.MOE, Family.SSM, Family.HYBRID)
# families the port serves but does not train or search yet
SERVING_ONLY = (Family.SSM, Family.HYBRID)


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family.value!r} is not yet ported to repro_torch "
            "(DENSE, MOE, SSM and HYBRID only; ROADMAP A5)"
        )


def check_trainable(cfg: ModelConfig, what: str) -> None:
    """Raise for a family the port serves but does not train, calibrate
    in a Trainer or search yet (``what`` names the refused path)."""
    if cfg.family in SERVING_ONLY:
        raise NotImplementedError(
            f"{what} on the {cfg.family.value} family ({cfg.name}) is not yet ported "
            "(ROADMAP A5: the port serves SSM and HYBRID models only)")


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, mamba_layers_per_group, tail_layers)."""
    k = cfg.shared_attn_every
    return cfg.n_layers // k, k, cfg.n_layers % k


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 256 when REPRO_PAD_VOCAB=1, as in
    the reference; logits are sliced back to the true vocab."""
    if os.environ.get("REPRO_PAD_VOCAB") == "1":
        return -(-cfg.vocab_size // 256) * 256
    return cfg.vocab_size


def init_params(cfg: ModelConfig, seed: int, device) -> Transformer:
    """Random weights from ``seed`` (normal, scaled by fan-in; norms one,
    biases zero) in ``cfg.param_dtype`` on ``device``: drawn from a CPU
    generator, tensor by tensor, and moved there, so one seed gives the
    same weights on every device.  A MoE block's expert stacks are drawn
    in parallel, each expert's tensors from a generator of their own
    (:func:`repro_torch.models.moe.init_moe`); so are the SSM blocks, each
    tensor from a generator seeded from ``(seed, layer, tensor)``
    (:func:`repro_torch.models.ssm.init_ssm_blocks`; a HYBRID model's
    layers numbered group-major, then the tail; its shared block comes
    from ``gen`` after the embedding)."""
    check_family(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    device = torch.device(device)
    gen = torch.Generator()
    gen.manual_seed(seed)
    V, D = padded_vocab(cfg), cfg.d_model

    def normal(shape, scale):
        return L._normal(gen, shape, scale, dtype, device)

    embed = normal((V, D), D ** -0.5)
    lm_head = None if cfg.tie_embeddings else normal((D, V), D ** -0.5)
    ones = lambda: torch.ones((D,), dtype=dtype, device=device)
    if cfg.family == Family.SSM:
        return Transformer(embed, ones(), S.init_ssm_blocks(cfg, dtype, device, seed,
                                                            range(cfg.n_layers)), lm_head)
    if cfg.family == Family.HYBRID:
        G, k, _ = hybrid_layout(cfg)
        shared = Block(ones(), ones(), L.init_attention(gen, cfg, dtype, device),
                       L.init_mlp(gen, cfg, dtype, device))
        blocks = S.init_ssm_blocks(cfg, dtype, device, seed, range(cfg.n_layers))
        groups = [nn.ModuleList(blocks[g * k:(g + 1) * k]) for g in range(G)]
        return Transformer(embed, ones(), groups, lm_head, shared=shared, tail=blocks[G * k:])
    layers = []
    for l in range(cfg.n_layers):
        attn = L.init_attention(gen, cfg, dtype, device)
        if cfg.n_experts:
            layers.append(Block(ones(), ones(), attn,
                                moe=M.init_moe(gen, cfg, dtype, device, seed, l)))
        else:
            layers.append(Block(ones(), ones(), attn, L.init_mlp(gen, cfg, dtype, device)))
    return Transformer(embed, ones(), layers, lm_head)


def init_calibration(cfg: ModelConfig, approx: ApproxConfig, device="cpu") -> Dict[str, Any]:
    """Zero calibration stats, laid out as the reference's: ``"layers"``
    maps each block site to a site whose leaves are stacked over the
    layers (``mean`` and ``var`` [L, deg+1], ``scale`` [L]), ``"head"``
    holds ``lm_head``.  Each site takes the degree of the backend it
    resolves to.  A MoE block has the attention sites and
    ``"moe_experts"``, the expert sites stacked ``[L, E, ...]``.  An SSM
    model's layers hold ``ssm_in`` and ``ssm_out``; a HYBRID model's
    ``"layers"`` are stacked ``[G, k, ...]``, ``"shared"`` holds the
    attention and MLP sites ``[G, ...]`` (one set of stats for each
    application of the shared block) and ``"tail"`` ``[t, ...]``."""
    check_family(cfg)
    n = cfg.n_layers

    def stacked(sites, lead):
        out = {}
        for site in sites:
            one = calib_lib.init_site_for(approx, site, device)
            out[site] = {k: v.expand(lead + v.shape).clone() for k, v in one.items()}
        return out

    head = {"lm_head": calib_lib.init_site_for(approx, "lm_head", device)}
    if cfg.family == Family.SSM:
        return {"layers": stacked(SSM_SITES, (n,)), "head": head}
    if cfg.family == Family.HYBRID:
        G, k, tail = hybrid_layout(cfg)
        out = {"layers": stacked(SSM_SITES, (G, k)),
               "shared": stacked(ATTN_SITES + MLP_SITES, (G,)), "head": head}
        if tail:
            out["tail"] = stacked(SSM_SITES, (tail,))
        return out
    layers = stacked(ATTN_SITES if cfg.n_experts else ATTN_SITES + MLP_SITES, (n,))
    if cfg.n_experts:
        layers["moe_experts"] = stacked(MOE_SITES, (n, cfg.n_experts))
    return {"layers": layers, "head": head}


def layer_calibration(calib: Dict[str, Any], l: int, part: str = "layers",
                      j: Optional[int] = None) -> Dict[str, Any]:
    """The sites of layer ``l`` of ``part`` of a calibration tree (the
    expert stack's ``[E, ...]`` slice included); with ``j``, mamba layer
    ``j`` of a HYBRID model's group ``l``."""
    out = M.index_tree(calib[part], l)
    return out if j is None else M.index_tree(out, j)


def _stack_layers(per_layer) -> Dict[str, Any]:
    """The layers' collected sites, stacked as :func:`init_calibration`
    lays them out."""
    return M.stack_trees(per_layer)


@dataclasses.dataclass
class ApplyOutput:
    logits: torch.Tensor
    cache: Optional[Dict[str, Any]] = None  # prefill KV cache
    collected: Optional[Dict[str, Any]] = None  # calibration pass: fitted stats
    aux_loss: Optional[torch.Tensor] = None  # float32, summed over layers (0 for DENSE)


def _attn_block_apply(x, p: Block, cfg, ctx, positions, chunk_q):
    h, kv = L.attention(
        L.rmsnorm(x, p.ln1, cfg.norm_eps), p.attn, cfg, ctx, positions, chunk_q=chunk_q
    )
    x = x + h
    if cfg.n_experts:
        f, aux = M.moe_ffn(L.rmsnorm(x, p.ln2, cfg.norm_eps), p.moe, cfg, ctx)
    else:
        f = L.mlp(L.rmsnorm(x, p.ln2, cfg.norm_eps), p.mlp, ctx)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux, kv


def _ssm_block_apply(x, p: S.SSMBlock, cfg, ctx, mask, return_cache: bool):
    """``x + ssm(rmsnorm(x))`` and, with ``return_cache``, the block's
    decode cache (else None)."""
    h = S.ssm_block(L.rmsnorm(x, p.ln1, cfg.norm_eps), p.ssm, cfg, ctx, mask=mask,
                    return_cache=return_cache)
    h, cache = h if return_cache else (h, None)
    return x + h, cache


def _embed(params: Transformer, cfg: ModelConfig, batch, dtype):
    return params.embed[batch["tokens"]].to(dtype)


def _lm_head(x, params: Transformer, cfg: ModelConfig, ctx):
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = dense(x, w.to(x.dtype), site="lm_head", ctx=ctx)
    if logits.shape[-1] != cfg.vocab_size:  # drop vocab-padding columns
        logits = logits[..., : cfg.vocab_size]
    return logits


def apply_model(
    params: Transformer,
    batch,
    cfg: ModelConfig,
    *,
    approx: ApproxConfig = ApproxConfig(),
    chunk_q: int = 1024,
    return_cache: bool = False,
    rng: Optional[Tuple[int, ...]] = None,
    draws: Optional[Callable] = None,
    calib: Optional[Dict[str, Any]] = None,
    collect: bool = False,
    remat: str = "block",
    chip=None,
    correct: bool = False,
    calib_exact_ref: bool = False,
    blend=None,
    backend_idx=None,
    bwd_gate=None,
    seq_lens=None,
) -> ApplyOutput:
    """Full-sequence forward.  batch: {'tokens': [B, T] int}.

    ``seq_lens`` ([B], each row's true length in a right-padded batch: a
    bulk prefill) freezes the SSM mixers' recurrences past each row's
    length, so an SSM or HYBRID cache holds each row's state at its
    length.  Right-padded rows need no masking for attention: decode never
    looks past a slot's position.  In a MoE model they take expert
    capacity, as in the reference.  The output's ``aux_loss`` is the float32 sum of the
    layers' load-balance losses (0 for DENSE).  With ``return_cache`` the output
    carries the KV cache laid out as
    :func:`repro_torch.models.decode.init_cache` with ``max_seq = T``.

    ``rng`` (a key path, default ``(0,)``) and ``draws`` feed the
    stochastic backends and INJECT mode's noise (see :class:`ApproxCtx`):
    layer ``l`` folds in ``l`` and the LM head ``2**20``, as the reference
    does; in a HYBRID model group g's mamba layer j folds ``g (k + 1) +
    j``, its application of the shared block ``g (k + 1) + k``, and tail
    layer j ``G (k + 1) + j``.  ``calib`` (default: zero stats, :func:`init_calibration`, where
    INJECT mode or a calibration pass reads them) gives each layer's ctx
    its sites; with ``collect`` the forward is a
    calibration pass and the output carries the fitted stats, laid out as
    ``calib``.  ``remat`` is each layer's activation-checkpointing policy
    (:func:`repro_torch.core.checkpoint_policy.wrap_block`), as in the
    reference: ``"block"`` unless the caller says otherwise, and ``"none"``
    with ``return_cache``.

    ``chip`` (a :class:`repro_torch.hw.variation.ChipProfile`) is the
    device instance every emulated projection runs on; ``correct``
    subtracts ``calib``'s fitted mean error from MODEL-mode outputs, and
    ``calib_exact_ref`` makes a calibration pass fit those stats against
    the exact matmul (see :class:`ApproxCtx`).

    ``blend`` (a scalar tensor) is the sensitivity probe threaded into
    every layer's ctx (``ApproxCtx.blend``).  ``backend_idx`` switches
    every layer to runtime backend dispatch (``ApproxCtx.site_idx``,
    :mod:`repro_torch.core.switch`): an int32 ``[n_sites]`` array over
    ``switch.SITE_ORDER`` for every layer and the head, or
    :func:`repro_torch.core.switch.model_indices`' ``{"layers": [L, S],
    "head": [S]}`` giving each layer its own map (HYBRID: ``"layers"`` [G,
    k, S], ``"shared"`` [G, S] and ``"tail"`` [t, S]).  Host arrays: the
    index is read on the host.

    ``bwd_gate`` (int32 ``[n_sites]`` over ``switch.SITE_ORDER``, a host
    array) is every layer's and the head's ``ApproxCtx.bwd_gate``: a site
    gated open runs its gradient matmuls on the int8 grid (the approximate
    backward); the forward is the same whatever the mask.
    """
    check_family(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    x = _embed(params, cfg, batch, dtype)
    B, T, _ = x.shape
    positions = torch.arange(T, dtype=torch.int32, device=x.device).expand(B, T)
    if calib is None and (collect or approx.mode == TrainMode.INJECT):
        calib = init_calibration(cfg, approx, x.device)
    idx: Dict[str, Any] = {}  # per part: a host index array a layer (or group)
    b_head = None
    if isinstance(backend_idx, dict):
        idx = {k: np.asarray(v, np.int32) for k, v in backend_idx.items() if k != "head"}
        b_head = np.asarray(backend_idx["head"], np.int32)
    elif backend_idx is not None:
        b_head = np.asarray(backend_idx, np.int32)
    if bwd_gate is not None:
        bwd_gate = np.asarray(bwd_gate, np.int32)
    ctx = ApproxCtx(cfg=approx, rng=tuple(rng) if rng is not None else (0,), draws=draws,
                    collect=collect, chip=chip, correct=correct,
                    calib_exact_ref=calib_exact_ref, blend=blend, site_idx=b_head,
                    bwd_gate=bwd_gate)
    remat = "none" if return_cache else remat

    def sub_ctx(fold, part, i, j=None):
        """The ctx of one block: ``fold`` in its path, its calibration
        sites and its index row."""
        c = ctx.for_layer(fold, None if calib is None else layer_calibration(calib, i, part, j))
        if part in idx:
            c.site_idx = idx[part][i] if j is None else idx[part][i][j]
        return c

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    collected: Dict[str, Any] = {}
    cache: Dict[str, Any] = {}
    if cfg.family in (Family.SSM, Family.HYBRID):
        block = checkpoint_policy.wrap_block(_ssm_block_apply, remat)
        seq_mask = None
        if seq_lens is not None:
            lens = torch.as_tensor(seq_lens, device=x.device).reshape(-1, 1)
            seq_mask = torch.arange(T, device=x.device)[None, :] < lens

        def mamba(x, p, lctx):
            x, c = block(x, p, cfg, lctx, seq_mask, return_cache)
            return x, c, lctx.collected

        if cfg.family == Family.SSM:
            caches, coll = [], []
            for l, p in enumerate(params.layers):
                x, c, col = mamba(x, p, sub_ctx(l, "layers", l))
                caches.append(c)
                coll.append(col)
            collected["layers"] = coll
            if return_cache:
                cache = M.stack_trees(caches)
        else:
            G, k, tail = hybrid_layout(cfg)
            attn = checkpoint_policy.wrap_block(_attn_block_apply, remat)
            g_caches, g_coll, kv, sh_coll = [], [], [], []
            for g, group in enumerate(params.layers):
                caches, coll = [], []
                for j, p in enumerate(group):
                    x, c, col = mamba(x, p, sub_ctx(g * (k + 1) + j, "layers", g, j))
                    caches.append(c)
                    coll.append(col)
                sctx = sub_ctx(g * (k + 1) + k, "shared", g)
                x, aux, kv_g = attn(x, params.shared, cfg, sctx, positions, chunk_q)
                aux_total = aux_total + aux
                g_caches.append(caches)
                g_coll.append(M.stack_trees(coll))
                sh_coll.append(sctx.collected)
                if return_cache:
                    kv.append(kv_g)
            sctx = None
            collected["layers"] = g_coll
            collected["shared"] = sh_coll
            t_caches, t_coll = [], []
            for j, p in enumerate(params.tail or ()):
                x, c, col = mamba(x, p, sub_ctx(G * (k + 1) + j, "tail", j))
                t_caches.append(c)
                t_coll.append(col)
            if tail:
                collected["tail"] = t_coll
            if return_cache:
                cache = {"mamba": M.stack_trees([M.stack_trees(c) for c in g_caches]),
                         "shared": {"k": torch.stack([a for a, _ in kv]),
                                    "v": torch.stack([b for _, b in kv])}}
                if tail:
                    cache["tail"] = M.stack_trees(t_caches)
    else:
        block = checkpoint_policy.wrap_block(_attn_block_apply, remat)
        ks, vs, coll = [], [], []
        for l, p in enumerate(params.layers):
            lctx = sub_ctx(l, "layers", l)
            x, aux, (k_l, v_l) = block(x, p, cfg, lctx, positions, chunk_q)
            aux_total = aux_total + aux
            coll.append(lctx.collected)
            if return_cache:
                ks.append(k_l)
                vs.append(v_l)
        collected["layers"] = coll
        if return_cache:
            cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    lctx = None  # the last layer's draws go before the head draws its own
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    hctx = ctx.for_layer(HEAD_FOLD, None if calib is None else calib["head"])
    logits = _lm_head(x, params, cfg, hctx)
    if collect:
        collected = {k: (v if isinstance(v, dict) else _stack_layers(v))
                     for k, v in collected.items()}
        collected["head"] = hctx.collected
    return ApplyOutput(logits=logits, cache=cache if return_cache else None,
                       collected=collected if collect else None, aux_loss=aux_total)
