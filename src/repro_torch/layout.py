"""The reference's parameter layout, for the modules that must follow it.

The reference keeps its parameters as nested dicts, one ``[L, ...]`` leaf
for each per-layer tensor, and ``jax.tree_util`` flattens them in sorted
key order.  Checkpoints (:mod:`repro_torch.ckpt.manager`), the converter
(:mod:`repro_torch.convert`) and AdamW's rounding draws and SM3 factors
(:mod:`repro_torch.optim.adamw`) all go by that order, so it lives here,
below all three.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key path, leaf)`` of a tree of nested dicts, in the order and
    with the paths of ``jax.tree_util`` (sorted keys)."""
    out = []
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}[{k!r}]"
        out.extend(flatten(v, path) if isinstance(v, dict) else [(path, v)])
    return out


def named_paths(names) -> Dict[str, Any]:
    """The reference's parameter layout of the port's parameter ``names``:
    the same nested dicts, each leaf the name it holds, or for a leaf the
    reference stacks over the layers the tuple of its layers' names."""
    names = list(names)
    n_layers = 1 + max(int(k.split(".")[1]) for k in names if k.startswith("layers."))

    def stacked(suffix):
        return tuple(f"layers.{l}.{suffix}" for l in range(n_layers))

    parts = {}  # attn, and mlp or (the MoE family) moe
    for k in names:
        if k.startswith("layers.0."):
            _, _, part, *leaf = k.split(".")
            if leaf:
                parts.setdefault(part, {})[leaf[0]] = stacked(f"{part}.{leaf[0]}")
    tree = {
        "embed": {"tok": "embed"},
        "final_norm": "final_norm",
        "layers": {"ln1": stacked("ln1"), "ln2": stacked("ln2"), **parts},
    }
    if "lm_head" in names:
        tree["head"] = {"lm_head": "lm_head"}
    return tree
