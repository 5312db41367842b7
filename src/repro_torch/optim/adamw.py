"""AdamW with float32 master weights, global-norm clipping and a cosine
schedule (port of the uncompressed path of ``repro.optim.adamw``:
``lr_at``, ``adamw_init``, ``adamw_update``; and of
``repro.utils.tree.tree_global_norm``).

Functions on tensors, not ``torch.optim.AdamW``: the reference's eps
placement, bias correction, decay and schedule hold exactly.  The state is
``{"m", "v", "master", "count"}``, each slot a dict keyed by parameter
name (``Transformer.named_parameters()``), m and v float32.  A float32
parameter is its own master (the two would always be equal), so only
lower-precision parameters pay for a float32 copy.  :func:`adamw_update`
updates the state and the parameters in place.

Python constants meet tensors as the reference's weak types do: a
float32 operand rounds them to float32, and a constant divided by a
tensor is a float32 division (:func:`_f32`), not PyTorch's reciprocal
times the constant.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

from repro_torch.configs.base import TrainConfig


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


def decays(name: str, t: torch.Tensor) -> bool:
    """Whether parameter ``name`` takes weight decay.  The reference decays
    tensors of rank >= 2 in its layout, which stacks each layer's tensors
    over the layers ([L, ...]): there every per-layer tensor (norms and
    biases too) has rank >= 2, and only the final norm is a vector."""
    return t.dim() >= 2 or name.startswith("layers.")


def adamw_init(named: Dict[str, torch.Tensor]):
    """Optimizer state for the parameters ``named`` (name -> tensor)."""
    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    master = {
        n: t.data if t.dtype == torch.float32 else t.detach().to(torch.float32)
        for n, t in named.items()
    }
    first = next(iter(named.values()))
    return {
        "m": {n: zeros(t) for n, t in named.items()},
        "v": {n: zeros(t) for n, t in named.items()},
        "master": master,
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], opt, named: Dict[str, torch.Tensor],
                 cfg: TrainConfig):
    """One AdamW step: updates ``opt`` and the parameters ``named`` in place
    and returns ``{"grad_norm", "lr"}``.  ``grads`` maps each name to its
    gradient (any float dtype), in the order of ``named``."""
    count = opt["count"] + 1
    lr = lr_at(count, cfg)
    gnorm = tree_global_norm(grads[n] for n in named)
    scale = torch.clamp_max(_f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9), 1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1 - b1 ** count.to(torch.float32)
    c2 = 1 - b2 ** count.to(torch.float32)
    for n, p in named.items():
        g = grads[n].to(torch.float32) * scale
        m = b1 * opt["m"][n] + (1 - b1) * g
        v = b2 * opt["v"][n] + (1 - b2) * torch.square(g)
        master = opt["master"][n]
        step = m / c1 / (torch.sqrt(v / c2) + cfg.eps)
        wd = cfg.weight_decay * master if decays(n, p) else 0.0
        master.copy_(master - lr * (step + wd))
        opt["m"][n].copy_(m)
        opt["v"][n].copy_(v)
        if master.data_ptr() != p.data_ptr():
            p.copy_(master)
    opt["count"] = count
    return {"grad_norm": gnorm, "lr": lr}
