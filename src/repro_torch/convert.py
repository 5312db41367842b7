"""Carry weights and training state across from the JAX reference.

``params_from_jax(tree)`` takes the reference's parameter pytree after
``jax.tree.map(np.asarray, params)`` — layer leaves stacked as ``[L,
...]``, a MoE block's expert stacks ``[L, E, ...]``, a HYBRID model's
mamba layers ``[G, k, ...]`` beside its ``shared`` block and its ``tail``
``[t, ...]`` — and returns the port's :class:`~repro_torch.models.
transformer.Transformer` holding the same values, so both packages
compute the same function, on ``device`` (the card unless the caller
asks for the CPU, as the port's other entry points).
``train_state_from_jax(state)`` does the same for a whole train state:
the parameters, AdamW's ``m``, ``v``, ``master`` and ``count``, the
calibration tree and the step.  ``train_state_to_numpy(state)`` goes the
other way, into the reference's layout.  Only numpy is read; bfloat16
arrays (numpy's ``ml_dtypes`` extension type) are reinterpreted bit for
bit.

``train_state_layout(state)`` is the reference's layout without copies:
the same nested dicts, whose leaves are the port's own tensors, with a
:class:`Stacked` where the reference stacks one tensor per layer.  The
checkpoint manager (:mod:`repro_torch.ckpt.manager`) writes and restores
a train state through it, on the host with torch alone.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from repro_torch.layout import flatten, named_paths
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM, SSMBlock
from repro_torch.models.transformer import Block, Transformer
from repro_torch.optim.adamw import adamw_init


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    shape, a = a.shape, np.ascontiguousarray(a)  # (which makes a 0-dim array 1-dim)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.reshape(shape).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as the reference's arrays carry it

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


class Stacked:
    """One tensor per layer that the reference's layout stacks into one
    ``[L, ...]`` leaf (for a HYBRID model's ``[G, k, ...]`` leaves, one
    :class:`Stacked` per group)."""

    def __init__(self, tensors):
        self.tensors = list(tensors)
        first = self.tensors[0]
        self.shape = (len(self.tensors),) + tuple(first.shape)
        self.dtype = first.dtype

    def host(self) -> torch.Tensor:
        """The stacked leaf in host memory: each layer copied into its slice."""
        out = torch.empty(self.shape, dtype=self.dtype)
        for l, t in enumerate(self.tensors):
            out[l].copy_(t.host() if isinstance(t, Stacked) else t.detach())
        return out

    @torch.no_grad()
    def load_(self, stacked: torch.Tensor) -> None:
        """Copy slice ``l`` of ``stacked`` into layer ``l``'s tensor, in place."""
        for l, t in enumerate(self.tensors):
            t.load_(stacked[l]) if isinstance(t, Stacked) else t.copy_(stacked[l])


def _map_names(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_names(v, fn) for k, v in tree.items()}
    return fn(tree)


def named_layout(named: Dict[str, Any]) -> Dict[str, Any]:
    """``{port parameter name: tensor}`` (the parameters, or an AdamW slot)
    in the reference's parameter layout, its layer leaves :class:`Stacked`
    (no copies).  An SM3 entry ``{"r", "c"}`` becomes the reference's
    ``{"r", "c"}`` leaf: each factor stacked over the layers, but a ``c``
    that every layer shares (a per-layer vector's) the one tensor."""

    def leaf(ns):
        if isinstance(ns, str):
            return named[ns]
        entries = [leaf(n) for n in ns]
        if not isinstance(entries[0], dict):
            return Stacked(entries)
        out = {}
        for k in ("c", "r"):
            ts = [e[k] for e in entries]
            out[k] = ts[0] if all(t is ts[0] for t in ts) else Stacked(ts)
        return out

    return _map_names(named_paths(named), leaf)


def train_state_layout(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's train state in the reference's layout, without copies:
    its tensors (layer leaves :class:`Stacked`) and, for the step, an
    int32 numpy scalar.  A float32 parameter is its own master, so both
    leaves hold the one tensor."""
    opt = state["opt"]
    return {
        "params": named_layout(dict(state["params"].named_parameters())),
        "opt": {"m": named_layout(opt["m"]), "v": named_layout(opt["v"]),
                "master": named_layout(opt["master"]), "count": opt["count"]},
        "calib": state["calib"],
        "step": np.asarray(state["step"], np.int32),
    }


def _attn_block(lay, idx, device) -> Block:
    """The attention block at ``idx`` of the reference's stacked leaves
    (``()`` for the hybrid's unstacked shared block)."""
    a = {k: _tensor(v[idx], device) for k, v in lay["attn"].items()}
    ln = (_tensor(lay["ln1"][idx], device), _tensor(lay["ln2"][idx], device))
    if "moe" in lay:
        return Block(*ln, L.Attention(**a), moe=MoE(**{k: _tensor(v[idx], device)
                                                       for k, v in lay["moe"].items()}))
    return Block(*ln, L.Attention(**a), L.MLP(**{k: _tensor(v[idx], device)
                                                 for k, v in lay["mlp"].items()}))


def _ssm_block(lay, idx, device) -> SSMBlock:
    return SSMBlock(_tensor(lay["ln1"][idx], device),
                    SSM(**{k: _tensor(v[idx], device) for k, v in lay["ssm"].items()}))


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Transformer:
    lay = tree["layers"]
    shared = tail = None
    if "ssm" in lay and "shared" in tree:  # HYBRID: [G, k, ...] mamba layers
        G, k = np.asarray(lay["ln1"]).shape[:2]
        layers = [nn.ModuleList([_ssm_block(lay, (g, j), device) for j in range(k)])
                  for g in range(G)]
        shared = _attn_block(tree["shared"], (), device)
        if "tail" in tree:
            tail = [_ssm_block(tree["tail"], j, device)
                    for j in range(np.asarray(tree["tail"]["ln1"]).shape[0])]
    elif "ssm" in lay:
        layers = [_ssm_block(lay, l, device) for l in range(lay["ln1"].shape[0])]
    else:
        layers = [_attn_block(lay, l, device) for l in range(lay["ln1"].shape[0])]
    head = tree.get("head", {}).get("lm_head")
    return Transformer(
        _tensor(tree["embed"]["tok"], device),
        _tensor(tree["final_norm"], device),
        layers,
        None if head is None else _tensor(head, device),
        shared=shared,
        tail=tail,
    )


def _named_blocks(out, prefix, lay, lead):
    """``{prefix.<i>[.<j>].name: slice}`` of the stacked leaves ``lay``
    over their ``lead`` leading axes."""
    for idx in np.ndindex(*lead):
        at = ".".join([prefix] + [str(i) for i in idx]) if prefix else ""
        for k, v in lay.items():
            if isinstance(v, dict):
                for n, a in v.items():
                    out[f"{at}.{k}.{n}" if at else f"{k}.{n}"] = a[idx]
            else:
                out[f"{at}.{k}" if at else k] = v[idx]


def named_from_jax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A tree shaped like the reference's parameters (its params, or an
    AdamW slot) as ``{port parameter name: array}``, layer leaves sliced."""
    out = {"embed": tree["embed"]["tok"], "final_norm": tree["final_norm"]}
    lay = tree["layers"]
    hybrid = "shared" in tree
    _named_blocks(out, "layers", lay, np.shape(lay["ln1"])[:2 if hybrid else 1])
    if hybrid:
        _named_blocks(out, "shared", tree["shared"], ())
    if "tail" in tree:
        _named_blocks(out, "tail", tree["tail"], np.shape(tree["tail"]["ln1"])[:1])
    head = tree.get("head", {}).get("lm_head")
    if head is not None:
        out["lm_head"] = head
    return out


def named_to_jax(named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``{port parameter name: tensor}`` as numpy in the reference's
    parameter layout, layer leaves stacked."""
    return _tree_to(named_layout(named))


def _tree_from(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from(v, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree), device)


def _tree_to(tree):
    if isinstance(tree, dict):
        return {k: _tree_to(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return tree
    return _numpy(tree.host() if isinstance(tree, Stacked) else tree)


def train_state_from_jax(state: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference's train state (``jax.tree.map(np.asarray, state)``) as
    the port's (:func:`repro_torch.training.steps.init_train_state`): the
    same parameters, trainable; AdamW's slots, compressed as the
    reference's are (bf16 m, SM3 ``{"r", "c"}`` leaves), and a float32
    parameter its own master, which the reference keeps equal to it; the
    calibration tree; the step."""

    params = params_from_jax(state["params"], device)
    for p in params.parameters():
        p.requires_grad_(True)
    named = dict(params.named_parameters())
    jopt = state["opt"]
    compress = ("none" if np.asarray(jopt["m"]["final_norm"]).dtype == np.float32
                else "sm3" if isinstance(jopt["v"]["embed"]["tok"], dict) else "bf16")
    opt = adamw_init(named, compress)
    with torch.no_grad():
        for slot in ("m", "v", "master"):
            port, ref = flatten(named_layout(opt[slot])), flatten(jopt[slot])
            if [p for p, _ in port] != [p for p, _ in ref]:
                raise ValueError(f"the reference's opt[{slot!r}] is not laid out as the port's")
            for (_, leaf), (_, a) in zip(port, ref):
                t = _tensor(a, "cpu")
                leaf.load_(t) if isinstance(leaf, Stacked) else leaf.copy_(t)
    opt["count"] = torch.tensor(int(np.asarray(jopt["count"])), dtype=torch.int32,
                                device=params.device)
    return {"params": params, "opt": opt, "calib": _tree_from(state["calib"], params.device),
            "step": int(np.asarray(state["step"]))}


def train_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's train state as numpy in the reference's layout."""
    return _tree_to(train_state_layout(state))


def calib_from_jax(tree, device="cuda"):
    """A reference calibration tree (or one site's stats), as numpy, as
    the port's: the same nested dicts of float32 tensors on ``device``
    (a MoE tree's ``moe_experts`` stacked ``[L, E, ...]`` as it is)."""
    return _tree_from(tree, torch.device(device))


def chip_from_jax(profile: Dict[str, Any]):
    """A reference chip profile (``jax.tree.map(np.asarray, profile)``,
    its key a uint32 pair) as the port's
    (:func:`repro_torch.hw.variation.sample_profile`'s layout): the key a
    pair of ints, the seed an int32 0-d tensor, the other leaves float32
    0-d tensors on the host, and no per-column draws made yet."""
    out = {}
    for k, v in profile.items():
        if k == "key":
            out[k] = tuple(int(x) for x in np.asarray(v).reshape(-1))
        elif isinstance(v, dict):
            out[k] = chip_from_jax(v) if k == "base" else {
                n: torch.tensor(np.asarray(a, np.float32)) for n, a in v.items()}
        elif k == "seed":
            out[k] = torch.tensor(np.asarray(v, np.int32))
        else:
            out[k] = torch.tensor(np.asarray(v, np.float32))
    if "base" in out:
        out["draws"] = {}
    return out
