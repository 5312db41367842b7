"""AdamW with float32 master weights, global-norm clipping, a cosine
schedule and compressed state (port of ``repro.optim.adamw``: ``lr_at``,
``adamw_init``, ``adamw_update``, ``_stochastic_round_bf16``,
``_factored_vhat`` and ``state_bytes``; and of
``repro.utils.tree.tree_global_norm``).

Functions on tensors, not ``torch.optim.AdamW``: the reference's eps
placement, bias correction, decay and schedule hold exactly.  The state is
``{"m", "v", "master", "count"}``, each slot a dict keyed by parameter
name (``Transformer.named_parameters()``).  A float32 parameter is its own
master (the two would always be equal), so only lower-precision
parameters pay for a float32 copy.  :func:`adamw_update` updates the state
and the parameters in place.

``compress`` (``TrainConfig.optim_compress``) is the reference's:

* ``"none"``: m and v float32.
* ``"bf16"``: m stored in bfloat16 with stochastic rounding.  The EMA is
  taken in float32 each step and this step's update reads it unrounded;
  only the stored m is rounded.  The rounding's draws are keyed on the
  step count alone (``fold_in(PRNGKey(0x5F3759DF), count)``, split once
  per leaf of the reference's parameter tree in its flatten order), so a
  restored run replays bitwise.  On the card each tensor is one launch of
  ``csrc/prng.cu`` (:func:`repro_torch.kernels.ops.stochastic_round_bf16`).
* ``"sm3"``: bf16 m, and the second moment of every leaf of rank >= 2 *in
  the reference's layout* factored into a row EMA ``r`` (mean of g² over
  the last axis) and a column EMA ``c`` (mean over the one before),
  ``v_hat = r / max(mean(r), eps) * c`` (Adafactor).  The reference
  stacks each layer's tensors into one ``[L, ...]`` leaf, so a per-layer
  matrix ``[K, N]`` has its own ``r`` [K] and ``c`` [N], while a per-layer
  vector (a norm or a bias, ``[d]`` in ``[L, d]``) has a scalar ``r`` of
  its own and shares one ``c`` [d] with every layer: the mean of g² over
  the layers, and ``mean(r)`` is taken over the layers too.  The port
  keeps that: those entries' ``c`` is one tensor for all layers.

A stacked leaf's per-layer tensor takes that leaf's draws at the flat
counters of its slice, ``l * numel ..``.  SM3's means are
:func:`xla_mean`: the reference's ``jnp.mean`` to the bit, whose sums XLA
takes in windows of 32.

Python constants meet tensors as the reference's weak types do: a
float32 operand rounds them to float32, and a constant divided by a
tensor is a float32 division (:func:`_f32`), not PyTorch's reciprocal
times the constant.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import prng
from repro_torch.kernels.ref import const
from repro_torch.layout import flatten, named_paths

COMPRESS = ("none", "bf16", "sm3")
ROUND_SEED = 0x5F3759DF  # the reference's PRNGKey of the rounding draws
XLA_WINDOW = 32  # XLA:CPU's tree reduction: windows of 32, summed in order


def _f32(v, like) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def tree_global_norm(tensors: Iterable[torch.Tensor]):
    """sqrt of the sum of squares of every element, summed tensor by tensor
    in order, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32))) for t in tensors))


def lr_at(step, cfg: TrainConfig):
    """Linear warmup, then cosine decay to ``min_lr_ratio``; ``step`` a
    0-dim tensor."""
    step = step.to(torch.float32)
    warm = cfg.learning_rate * step / _f32(max(cfg.warmup_steps, 1), step)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step),
        0.0, 1.0,
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def _sum_rows(t):
    """The sum over dim -2 of ``t``, row after row from zero."""
    acc = torch.zeros_like(t[..., 0, :])
    for j in range(t.shape[-2]):
        acc = acc + t[..., j, :]
    return acc


def xla_mean(t, dim: int):
    """``jnp.mean(t, axis=dim)`` of a float32 tensor as XLA:CPU computes
    it, bit for bit.  XLA rewrites a sum over more than 32 elements into
    windows of 32 (the axis padded with zeros, half before and half
    after), sums each window in order, and repeats on the windows' sums
    until 32 or fewer are left, which it sums in order; the mean divides
    by the count (correctly rounded).  A plain sum over the axis would
    take another order, and SM3's factors would drift from the
    reference's in their last bits."""
    n = t.shape[dim]
    t = t.movedim(dim, -1)
    while t.shape[-1] > XLA_WINDOW:
        m = t.shape[-1]
        blocks = -(-m // XLA_WINDOW)
        pad = blocks * XLA_WINDOW - m
        if pad:
            t = torch.nn.functional.pad(t, (pad // 2, pad - pad // 2))
        t = t.reshape(t.shape[:-1] + (blocks, XLA_WINDOW)).transpose(-1, -2).contiguous()
        t = _sum_rows(t)
    s = _sum_rows(t.unsqueeze(-1)).squeeze(-1)
    return s / const(float(n), s)


def decays(name: str, t: torch.Tensor) -> bool:
    """Whether parameter ``name`` takes weight decay.  The reference decays
    tensors of rank >= 2 in its layout, which stacks each layer's tensors
    over the layers ([L, ...]): there every per-layer tensor (norms and
    biases too) has rank >= 2, and only the final norm is a vector.  The
    same leaves are the ones SM3 factors."""
    return t.dim() >= 2 or name.startswith("layers.")


def _stacked_vector(name: str, t: torch.Tensor) -> bool:
    """A per-layer vector: a row of an ``[L, d]`` leaf of the reference."""
    return t.dim() == 1 and name.startswith("layers.")


@functools.lru_cache(maxsize=16)
def _leaf_slots(names: Tuple[str, ...]) -> Dict[str, Tuple[int, int]]:
    """``name -> (leaf, layer)``: the index of the reference leaf that holds
    parameter ``name`` in ``jax.tree_util``'s flatten order, and its slice
    of that leaf (0 for a leaf that is not stacked)."""
    out = {}
    for i, (_, ns) in enumerate(flatten(named_paths(names))):
        for l, n in enumerate((ns,) if isinstance(ns, str) else ns):
            out[n] = (i, l)
    return out


def _shared_columns(named: Dict[str, torch.Tensor]) -> Dict[str, list]:
    """The per-layer vectors grouped by their reference leaf (the layer
    index dropped from the name), each group in layer order."""
    groups: Dict[str, list] = {}
    slots = _leaf_slots(tuple(named))
    for n, t in named.items():
        if _stacked_vector(n, t):
            groups.setdefault(n.split(".", 2)[2], []).append(n)
    for ns in groups.values():
        ns.sort(key=lambda n: slots[n][1])
    return groups


def adamw_init(named: Dict[str, torch.Tensor], compress: str = "none"):
    """Optimizer state for the parameters ``named`` (name -> tensor);
    ``compress`` is ``TrainConfig.optim_compress``'s ``"none"``,
    ``"bf16"`` or ``"sm3"``."""
    if compress not in COMPRESS:
        raise ValueError(f"unknown optim_compress {compress!r}")
    m_dtype = torch.float32 if compress == "none" else torch.bfloat16
    zeros = lambda shape, t, dt=torch.float32: torch.zeros(shape, dtype=dt, device=t.device)
    shared = {}  # a per-layer vector's name -> the c [d] of its leaf, one for every layer
    if compress == "sm3":
        for ns in _shared_columns(named).values():
            c = zeros(named[ns[0]].shape, named[ns[0]])
            shared.update((n, c) for n in ns)
    v = {}
    for n, t in named.items():
        if n in shared:
            v[n] = {"r": zeros((), t), "c": shared[n]}
        elif compress == "sm3" and t.dim() >= 2:
            v[n] = {"r": zeros(t.shape[:-1], t), "c": zeros(t.shape[:-2] + t.shape[-1:], t)}
        else:
            v[n] = zeros(t.shape, t)
    master = {
        n: t.data if t.dtype == torch.float32 else t.detach().to(torch.float32)
        for n, t in named.items()
    }
    first = next(iter(named.values()))
    return {
        "m": {n: zeros(t.shape, t, m_dtype) for n, t in named.items()},
        "v": v,
        "master": master,
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def state_bytes(opt) -> int:
    """Bytes of the m and v slots (what ``optim_compress`` buys), counted
    over the reference's leaves: a ``c`` that the layers share counts
    once."""
    seen, total = set(), 0
    for slot in ("m", "v"):
        for entry in opt[slot].values():
            for t in entry.values() if isinstance(entry, dict) else (entry,):
                if id(t) not in seen:
                    seen.add(id(t))
                    total += t.numel() * t.element_size()
    return total


def _round_paths(count, n_leaves: int):
    """The rounding draws' key paths of one step as int32 words on the
    count's device, one row per reference leaf: ``(0x5F3759DF, count, i,
    1)``, i.e. ``split(split(fold_in(PRNGKey(0x5F3759DF), count), n)[i])
    [1]``, the key whose bits ``randint(..., 0, 2**16)`` keeps.  The count
    is copied on the device, so the host never waits for it."""
    rows = torch.tensor([prng.path_words((ROUND_SEED, 0, i, 1)) for i in range(n_leaves)],
                        dtype=torch.int32)
    if count.device.type == "cuda":
        rows = rows.pin_memory().to(count.device, non_blocking=True)
    rows[:, 1] = count
    return rows


def _factored_vhat(r, c, r_mean, eps: float):
    """``v_hat`` of a factored second moment: ``r / max(mean(r), eps)`` on
    the rows times ``c`` on the columns."""
    denom = torch.clamp_min(r_mean, eps)
    return (r / denom).unsqueeze(-1) * c.unsqueeze(-2)


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], opt, named: Dict[str, torch.Tensor],
                 cfg: TrainConfig):
    """One AdamW step: updates ``opt`` and the parameters ``named`` in place
    and returns ``{"grad_norm", "lr"}``.  ``grads`` maps each name to its
    gradient (any float dtype), in the order of ``named``; ``opt`` was made
    by :func:`adamw_init` with ``cfg.optim_compress``."""
    compress = cfg.optim_compress
    count = opt["count"] + 1
    lr = lr_at(count, cfg)
    gnorm = tree_global_norm(grads[n] for n in named)
    scale = torch.clamp_max(_f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9), 1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1 - b1 ** count.to(torch.float32)
    c2 = 1 - b2 ** count.to(torch.float32)
    scaled = lambda n: grads[n].to(torch.float32) * scale
    if compress != "none":
        slots = _leaf_slots(tuple(named))
        paths = _round_paths(count, 1 + max(i for i, _ in slots.values()))
    # the per-layer vectors under SM3: their shared c and the layers' mean
    # of r need every layer's gradient first
    r_means = {}
    if compress == "sm3":
        for ns in _shared_columns(named).values():
            g2 = torch.stack([torch.square(scaled(n)) for n in ns])  # [L, d]
            r_new = b2 * torch.stack([opt["v"][n]["r"] for n in ns]) + (1 - b2) * xla_mean(g2, -1)
            c = opt["v"][ns[0]]["c"]
            c.copy_(b2 * c + (1 - b2) * xla_mean(g2, -2))
            r_mean = xla_mean(r_new, -1)
            for n, r in zip(ns, r_new):
                opt["v"][n]["r"].copy_(r)
                r_means[n] = r_mean
    for n, p in named.items():
        g = scaled(n)
        m = b1 * opt["m"][n].to(torch.float32) + (1 - b1) * g
        v = opt["v"][n]
        if isinstance(v, dict):
            if n not in r_means:  # a matrix: its factors are its own
                g2 = torch.square(g)
                v["r"].copy_(b2 * v["r"] + (1 - b2) * xla_mean(g2, -1))
                v["c"].copy_(b2 * v["c"] + (1 - b2) * xla_mean(g2, -2))
                del g2
            r_mean = r_means.get(n)
            if r_mean is None:
                r_mean = xla_mean(v["r"], -1).unsqueeze(-1)
            vhat = _factored_vhat(v["r"], v["c"], r_mean, cfg.eps)
            if vhat.shape != m.shape:  # a per-layer vector's row of [L, d]
                vhat = vhat.reshape(m.shape)
        else:
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            vhat = v
        master = opt["master"][n]
        step = m / c1 / (torch.sqrt(vhat / c2) + cfg.eps)
        wd = cfg.weight_decay * master if decays(n, p) else 0.0
        master.copy_(master - lr * (step + wd))
        if compress == "none":
            opt["m"][n].copy_(m)
        else:
            leaf, layer = slots[n]
            opt["m"][n].copy_(kops.stochastic_round_bf16(m, paths[leaf], layer * m.numel()))
        if master.data_ptr() != p.data_ptr():
            p.copy_(master)
    opt["count"] = count
    return {"grad_norm": gnorm, "lr": lr}
