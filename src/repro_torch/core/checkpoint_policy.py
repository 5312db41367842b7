"""Activation-checkpointing policies (port of ``repro.core.
checkpoint_policy``; paper Sec. 3.4).

The proxy and injection machinery adds pointwise ops to every
projection; saving their outputs would double activation memory for no
arithmetic benefit.  The paper recomputes all of them and keeps only
the matmul outputs.  The reference expresses that as ``jax.checkpoint``
with ``dots_with_no_batch_dims_saveable``; here it is
``torch.utils.checkpoint`` (non-reentrant) with a selective policy that
saves the outputs of plain matmuls without batch dims (``aten.mm``,
``aten.addmm``) and recomputes everything else, the emulation kernels
and INJECT's noise included.  Both are functions of the layer's inputs
and key path, so the recomputed values are the first pass's bits.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import check_remat

_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_with_no_batch_dims(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def _selective():
    return create_selective_checkpoint_contexts(_dots_with_no_batch_dims)


def wrap_block(fn, remat: str):
    """``fn`` (a per-layer block function) under the ``TrainConfig.remat``
    policy: ``none`` returns it as is, ``full`` saves nothing of its
    inside, ``block`` and ``group:<k>`` (which the reference treats
    exactly as ``block``) save the plain matmuls' outputs.  Without
    autograd recording there is nothing to save, and ``fn`` runs as is."""
    check_remat(remat)
    if remat == "none":
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        if remat == "full":
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_selective, **kwargs)

    return wrapped
