"""Carry weights across from the JAX reference.

``params_from_jax(tree)`` takes the reference's DENSE parameter pytree
after ``jax.tree.map(np.asarray, params)`` — layer leaves stacked as
``[L, ...]`` — and returns the port's :class:`~repro_torch.models.
transformer.Transformer` holding the same values, so both packages
compute the same function, on ``device`` (the card unless the caller
asks for the CPU, as the port's other entry points).  Only numpy is read;
bfloat16 arrays (numpy's ``ml_dtypes`` extension type) are reinterpreted
bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.transformer import Block, Transformer


def _tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Transformer:
    lay = tree["layers"]
    attn, mlp = lay["attn"], lay["mlp"]
    layers = []
    for l in range(lay["ln1"].shape[0]):
        a = {k: _tensor(v[l], device) for k, v in attn.items()}
        m = {k: _tensor(v[l], device) for k, v in mlp.items()}
        layers.append(Block(
            _tensor(lay["ln1"][l], device), _tensor(lay["ln2"][l], device),
            L.Attention(**a), L.MLP(**m),
        ))
    head = tree.get("head", {}).get("lm_head")
    return Transformer(
        _tensor(tree["embed"]["tok"], device),
        _tensor(tree["final_norm"], device),
        layers,
        None if head is None else _tensor(head, device),
    )
