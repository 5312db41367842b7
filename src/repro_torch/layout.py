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


def _stacked_part(names: List[str], part: str):
    """The reference's subtree ``part`` of the port's parameter ``names``
    under ``part.``: leaves stacked over one layer index (``layers.<l>``,
    ``tail.<l>``), over a group and a layer (a HYBRID model's
    ``layers.<g>.<j>``), or none (its ``shared`` block), each leaf the
    name it holds or the (nested) tuple of its layers' names."""
    rows = [n.split(".")[1:] for n in names if n.split(".")[0] == part]
    if not rows:
        return None
    depth = sum(1 for c in rows[0][:2] if c.isdigit())
    by_leaf: Dict[Tuple[str, ...], Dict[Tuple[int, ...], str]] = {}
    for r in rows:
        by_leaf.setdefault(tuple(r[depth:]), {})[tuple(int(i) for i in r[:depth])] = \
            ".".join([part] + r)
    out: Dict[str, Any] = {}
    for leaf, at in by_leaf.items():
        shape = tuple(1 + max(i[d] for i in at) for d in range(depth))

        def nest(idx, _at=at, _shape=shape):
            if len(idx) == depth:
                return _at[idx]
            return tuple(nest(idx + (i,)) for i in range(_shape[len(idx)]))

        node = out
        for k in leaf[:-1]:
            node = node.setdefault(k, {})
        node[leaf[-1]] = nest(())
    return out


def named_paths(names) -> Dict[str, Any]:
    """The reference's parameter layout of the port's parameter ``names``:
    the same nested dicts, each leaf the name it holds, or for a leaf the
    reference stacks over the layers the tuple of its layers' names (a
    HYBRID model's mamba layers: a tuple of groups, each a tuple of
    names)."""
    names = list(names)
    tree = {"embed": {"tok": "embed"}, "final_norm": "final_norm"}
    for part in ("layers", "shared", "tail"):
        sub = _stacked_part(names, part)
        if sub is not None:
            tree[part] = sub
    if "lm_head" in names:
        tree["head"] = {"lm_head": "lm_head"}
    return tree
