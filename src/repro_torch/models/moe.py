"""Mixture-of-Experts FFN with capacity-based scatter dispatch (port of
``repro.models.moe``: ``_dispatch_groups``, ``init_moe``, ``_expert_ffn``,
``moe_ffn`` and ``_dummy_calib``).

Top-k routing with renormalised gates; tokens are scattered into
``[E, C, D]`` expert buffers (capacity ``C`` from the token count, every
row of the batch included), each expert's SwiGLU runs through ``dense``
under a context of its own (so the approximate path applies per
expert), and the results are combined in the reference's order.

The router stays exact under ``skip_router``: a small, accuracy-critical
projection, which the paper keeps off the approximate substrate.

Expert ``e`` runs under a sub-context that carries only the config, its
own calibration slice, its key path and ``collect`` (the reference's
``ApproxCtx(cfg, calib_e, rng_e, collect)``): no ``fused``, ``chip``,
``correct``, ``calib_exact_ref``, ``blend``, ``site_idx`` or ``bwd_gate``,
so during decode the experts take the composed MODEL path.  Its key path
is the parent's ``moe_experts`` path with ``e`` appended: the reference
splits that key into ``E`` keys, and in the threefry layout ``split(key,
n)[i]`` is ``fold_in(key, i)``.  The sub-contexts share the parent's
draw memo, so in a decode step (one key for every layer) each expert site
draws and builds its SC tables once.

The reference's ``jax.vmap`` over the experts is a loop here: every
expert runs, one that no token chose included, and the SC and analog
emulators take their per-tensor activation scales per expert buffer, as
under ``vmap``.  Nothing here makes the host wait for the device: the
slots are index tensors, and no value is read back.
"""
from __future__ import annotations

import concurrent.futures
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import calibration
from repro_torch.core.approx_linear import ApproxCtx, dense
from repro_torch.models.layers import frozen

MOE_SITES = ("moe_gate", "moe_up", "moe_down")


class MoE(nn.Module):
    """``router`` [D, E] float32; ``w_gate`` and ``w_up`` [E, D, F] and
    ``w_down`` [E, F, D] in the parameter dtype (the reference's layout)."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router, self.w_gate, self.w_up, self.w_down = map(
            frozen, (router, w_gate, w_up, w_down))


def _dispatch_groups(S: int) -> int:
    """Hierarchical-dispatch group count from ``REPRO_MOE_GROUPS`` (0:
    global dispatch): with G groups, positions in the experts and the
    capacity are taken per group of ``S / G`` tokens."""
    g = int(os.environ.get("REPRO_MOE_GROUPS", "0"))
    if g > 1 and S % g == 0:
        return g
    return 0


def _expert_seed(seed: int, layer: int, expert: int, tensor: int) -> int:
    return int(np.random.SeedSequence([seed, layer, expert, tensor]).generate_state(
        1, np.uint64)[0])


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device, seed: int,
             layer: int) -> MoE:
    """The router from ``gen`` (as the dense layers draw theirs); each
    expert's three tensors from a CPU generator of their own, seeded from
    ``(seed, layer, expert, tensor)``, in a thread pool, each written into
    its slice of the stacked tensor on ``device``.  Scaled by fan-in as
    the reference's.  One seed gives the same weights on every device."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    router = (torch.randn((d, e), generator=gen, dtype=torch.float32) * d ** -0.5).to(device)
    stacks = [torch.empty((e, d, f), dtype=dtype, device=device),
              torch.empty((e, d, f), dtype=dtype, device=device),
              torch.empty((e, f, d), dtype=dtype, device=device)]
    scales = (d ** -0.5, d ** -0.5, f ** -0.5)

    def draw(job):
        t, i = job
        g = torch.Generator()
        g.manual_seed(_expert_seed(seed, layer, i, t))
        out = stacks[t][i]
        with torch.no_grad():
            out.copy_(torch.randn(out.shape, generator=g, dtype=dtype) * scales[t])

    jobs = [(t, i) for t in range(3) for i in range(e)]
    with concurrent.futures.ThreadPoolExecutor(max_workers=min(len(jobs),
                                                               os.cpu_count() or 1)) as pool:
        list(pool.map(draw, jobs))
    return MoE(router, *stacks)


def _expert_ffn(xe, wg, wu, wd, ctx: Optional[ApproxCtx]):
    g = dense(xe, wg, site="moe_gate", ctx=ctx)
    u = dense(xe, wu, site="moe_up", ctx=ctx)
    h = F.silu(g.to(torch.float32)).to(xe.dtype) * u
    return dense(h, wd, site="moe_down", ctx=ctx)


def _slots(flat_e, E: int, C: int):
    """Each assignment's slot in the ``[E * C + 1]`` buffer (``E * C``, the
    drop slot, past capacity) and whether it was kept, for assignments
    ``flat_e [..., N]`` in token-major order: its position in its expert
    is the count of earlier assignments to that expert."""
    onehot = (flat_e[..., None] == torch.arange(E, device=flat_e.device)).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=-2) * onehot).sum(-1) - 1
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)
    return slot, keep


def _combine(upd, dtype):
    """``upd [..., S, K, D]`` summed over k into zeros of ``dtype``, one
    add at a time in k order, each rounded to ``dtype``: the reference's
    scatter-add in update order (token-major, k inner), with no atomics."""
    acc = torch.zeros(upd.shape[:-2] + upd.shape[-1:], dtype=dtype, device=upd.device)
    for k in range(upd.shape[-2]):
        acc = acc + upd[..., k, :]
    return acc


def index_tree(tree, i: int):
    """Slice ``i`` of every leaf of a tree of nested dicts (a calibration
    tree's layer or expert)."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def stack_trees(trees):
    """Trees of one structure stacked leaf by leaf along a new first axis."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _expert_ctx(ctx: ApproxCtx, path, calib) -> ApproxCtx:
    """Expert sub-context: the config, the expert's calibration slice, its
    key path and ``collect``; the parent's draws hook and draw memo."""
    sub = ApproxCtx(cfg=ctx.cfg, rng=tuple(path), draws=ctx.draws, calib=calib,
                    collect=ctx.collect)
    sub._memo = ctx._memo
    return sub


def _route(xf, p: MoE, cfg: ModelConfig, ctx: Optional[ApproxCtx]):
    """The router in float32 over ``xf [S, D]``: (probs [S, E], the top-k
    experts [S, K], their renormalised gates [S, K])."""
    router_logits = dense(xf.to(torch.float32), p.router, site="moe_router", ctx=ctx)
    probs = torch.softmax(router_logits, dim=-1)
    # jax.lax.top_k: the larger value first, the lower index first on ties
    expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, : cfg.top_k]
    gate_vals = probs.gather(-1, expert_idx)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, expert_idx, gate_vals


def _run_experts(expert_in, p: MoE, ctx: Optional[ApproxCtx]):
    """Each expert's SwiGLU over its buffer ``expert_in [E, C, D]`` under
    its sub-context (the reference's ``jax.vmap(one)``); with ``collect``
    the fitted stats land in ``ctx.collected["moe_experts"]``, stacked
    over the experts."""
    E = expert_in.shape[0]
    if ctx is None:
        return torch.stack([_expert_ffn(expert_in[e], p.w_gate[e], p.w_up[e], p.w_down[e], None)
                            for e in range(E)])
    base = ctx.site_path("moe_experts")
    calib_e = ctx.calib.get("moe_experts") if ctx.calib else None
    if calib_e is None:
        calib_e = _dummy_calib(E, ctx, expert_in.device)
    outs, collected = [], []
    for e in range(E):
        sub = _expert_ctx(ctx, base + (e,), index_tree(calib_e, e))
        outs.append(_expert_ffn(expert_in[e], p.w_gate[e], p.w_up[e], p.w_down[e], sub))
        collected.append(sub.collected)
    if ctx.collect:
        ctx.collected["moe_experts"] = stack_trees(collected)
    return torch.stack(outs)


def moe_ffn(x, p: MoE, cfg: ModelConfig, ctx: Optional[ApproxCtx]):
    """x: [B, T, D] -> (out [B, T, D], aux_loss float32 scalar)."""
    B, T, D = x.shape
    S = B * T
    E, K = cfg.n_experts, cfg.top_k
    dev = x.device
    xf = x.reshape(S, D)
    probs, expert_idx, gate_vals = _route(xf, p, cfg, ctx)

    # Switch-style load-balance auxiliary loss
    chosen = (expert_idx[..., None] == torch.arange(E, device=dev)).to(torch.float32)
    density = chosen.sum(1).mean(0)  # fraction of tokens per expert (x K)
    density_proxy = probs.mean(0)
    aux_loss = E * torch.sum(density / K * density_proxy)

    # ---- capacity-based dispatch ----------------------------------------
    G = _dispatch_groups(S)
    if G:
        Sg = S // G
        C = max(8, int(Sg * K * cfg.capacity_factor / E))
        slot, keep = _slots(expert_idx.reshape(G, Sg * K), E, C)  # [G, Sg*K]
        tok = torch.arange(Sg * K, device=dev) // K  # token of each assignment
        rows = torch.arange(G, device=dev)[:, None]
        buf = x.new_zeros((G, E * C + 1, D)).index_put(
            (rows, slot), xf.reshape(G, Sg, D)[:, tok])
        expert_in = buf[:, : E * C].reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    else:
        C = max(8, int(S * K * cfg.capacity_factor / E))
        slot, keep = _slots(expert_idx.reshape(-1), E, C)  # [S*K]
        tok = torch.arange(S * K, device=dev) // K
        buf = x.new_zeros((E * C + 1, D)).index_put((slot,), xf[tok])
        expert_in = buf[: E * C].reshape(E, C, D)

    # ---- per-expert computation (the approximate path per expert) -------
    expert_out = _run_experts(expert_in, p, ctx)  # [E, G*C or C, D]

    # ---- combine ---------------------------------------------------------
    if G:
        flat_out = expert_out.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
        gathered = flat_out[rows, slot.clamp(0, E * C - 1)]  # [G, Sg*K, D]
        gates = gate_vals.reshape(G, Sg * K)
        shape = (G, Sg, K, D)
    else:
        flat_out = expert_out.reshape(E * C, D)
        gathered = flat_out[slot.clamp(0, E * C - 1)]  # [S*K, D]
        gates = gate_vals.reshape(-1)
        shape = (S, K, D)
    gathered = torch.where(keep[..., None], gathered, torch.zeros((), dtype=x.dtype, device=dev))
    upd = gathered * gates[..., None].to(x.dtype)
    combined = _combine(upd.reshape(shape), x.dtype)
    return combined.reshape(B, T, D), aux_loss


def _dummy_calib(E: int, ctx: ApproxCtx, device) -> Dict[str, Any]:
    """Zero calibration stacked over the experts, used before the first
    calibration (the sub-contexts read stats, never ``None``)."""
    one = {s: calibration.init_site_for(ctx.cfg, s, device) for s in MOE_SITES}
    return {s: {k: v.expand((E,) + v.shape) for k, v in st.items()} for s, st in one.items()}
