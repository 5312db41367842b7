"""Decoder-LM assembly, DENSE and MOE families (port of
``repro.models.transformer``: ``padded_vocab``, ``init_params``,
``init_calibration``, ``_attn_block_apply``, ``_embed``, ``_lm_head`` and
``apply_model`` with ``return_cache``, ``calib``, ``collect``, ``remat``,
``chip``, ``correct``, ``calib_exact_ref``, ``blend``, ``backend_idx`` and
``bwd_gate``).

The parameters are an ``nn.Module`` tree (:class:`Transformer`); a Python
loop over ``layers`` takes the place of the reference's ``lax.scan``.
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

# the value the reference folds into the forward's key for the LM head
HEAD_FOLD = 2**20
ATTN_SITES = ("attn_q", "attn_k", "attn_v", "attn_o")
MLP_SITES = ("mlp_gate", "mlp_up", "mlp_down")
MOE_SITES = M.MOE_SITES
# every dense() call-site name across the reference's zoo (its MoE and SSM
# sites too): the universe that --site-backend patterns are checked against
ALL_SITES = ATTN_SITES + MLP_SITES + MOE_SITES + ("ssm_in", "ssm_out", "moe_router", "lm_head")


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
    """Parameters of a DENSE or MoE decoder LM, in the reference's layouts:
    ``embed`` [V, D], projections [in, out], ``lm_head`` [D, V] (absent
    for tied embeddings)."""

    def __init__(self, embed, final_norm, layers: List[Block], lm_head=None):
        super().__init__()
        self.embed = L.frozen(embed)
        self.final_norm = L.frozen(final_norm)
        self.layers = nn.ModuleList(layers)
        self.lm_head = None if lm_head is None else L.frozen(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device


PORTED_FAMILIES = (Family.DENSE, Family.MOE)


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family.value!r} is not yet ported to repro_torch "
            "(DENSE and MOE only; ROADMAP A5)"
        )


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
    (:func:`repro_torch.models.moe.init_moe`)."""
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
    ``"moe_experts"``, the expert sites stacked ``[L, E, ...]``."""
    check_family(cfg)
    n = cfg.n_layers

    def stacked(sites, lead):
        out = {}
        for site in sites:
            one = calib_lib.init_site_for(approx, site, device)
            out[site] = {k: v.expand(lead + v.shape).clone() for k, v in one.items()}
        return out

    layers = stacked(ATTN_SITES if cfg.n_experts else ATTN_SITES + MLP_SITES, (n,))
    if cfg.n_experts:
        layers["moe_experts"] = stacked(MOE_SITES, (n, cfg.n_experts))
    head = {"lm_head": calib_lib.init_site_for(approx, "lm_head", device)}
    return {"layers": layers, "head": head}


def layer_calibration(calib: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l``'s sites of a calibration tree (the expert stack's
    ``[E, ...]`` slice included)."""
    return M.index_tree(calib["layers"], l)


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
) -> ApplyOutput:
    """Full-sequence forward.  batch: {'tokens': [B, T] int}.

    Right-padded rows need no masking for attention: decode never looks
    past a slot's position.  In a MoE model they take expert capacity, as
    in the reference.  The output's ``aux_loss`` is the float32 sum of the
    layers' load-balance losses (0 for DENSE).  With ``return_cache`` the output
    carries the KV cache laid out as
    :func:`repro_torch.models.decode.init_cache` with ``max_seq = T``.

    ``rng`` (a key path, default ``(0,)``) and ``draws`` feed the
    stochastic backends and INJECT mode's noise (see :class:`ApproxCtx`):
    layer ``l`` folds in ``l`` and the LM head ``2**20``, as the reference
    does.  ``calib`` (default: zero stats, :func:`init_calibration`, where
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
    "head": [S]}`` giving each layer its own map.  Host arrays: the index
    is read on the host.

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
    b_layers = b_head = None
    if isinstance(backend_idx, dict):
        b_layers = np.asarray(backend_idx["layers"], np.int32)
        b_head = np.asarray(backend_idx["head"], np.int32)
    elif backend_idx is not None:
        b_head = np.asarray(backend_idx, np.int32)
    if bwd_gate is not None:
        bwd_gate = np.asarray(bwd_gate, np.int32)
    ctx = ApproxCtx(cfg=approx, rng=tuple(rng) if rng is not None else (0,), draws=draws,
                    collect=collect, chip=chip, correct=correct,
                    calib_exact_ref=calib_exact_ref, blend=blend, site_idx=b_head,
                    bwd_gate=bwd_gate)
    block = checkpoint_policy.wrap_block(_attn_block_apply, "none" if return_cache else remat)
    ks, vs, coll = [], [], []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, p in enumerate(params.layers):
        lctx = ctx.for_layer(l, None if calib is None else layer_calibration(calib, l))
        if b_layers is not None:
            lctx.site_idx = b_layers[l]
        x, aux, (k, v) = block(x, p, cfg, lctx, positions, chunk_q)
        aux_total = aux_total + aux
        coll.append(lctx.collected)
        if return_cache:
            ks.append(k)
            vs.append(v)
    lctx = None  # the last layer's draws go before the head draws its own
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    hctx = ctx.for_layer(HEAD_FOLD, None if calib is None else calib["head"])
    logits = _lm_head(x, params, cfg, hctx)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if return_cache else None
    collected = {"layers": _stack_layers(coll), "head": hctx.collected} if collect else None
    return ApplyOutput(logits=logits, cache=cache, collected=collected, aux_loss=aux_total)
