"""Loss functions (port of ``repro.training.losses``)."""
from __future__ import annotations

import torch


def lm_loss(logits, labels, mask=None):
    """Next-token cross entropy, in float32.

    logits: [B, T, V]; labels: [B, T] int; mask: [B, T] optional.  The
    log-sum-exp is the reference's: shifted by the row's detached maximum
    (0 where that is not finite)."""
    logits = logits.to(torch.float32)
    amax = torch.amax(logits, dim=-1, keepdim=True).detach()
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    logz = torch.log(torch.sum(torch.exp(logits - amax), dim=-1)) + amax[..., 0]
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def accuracy(logits, labels, mask=None):
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels.long()).to(torch.float32)
    if mask is not None:
        mask = mask.to(torch.float32)
        return (correct * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return correct.mean()
