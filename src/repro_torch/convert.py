"""Carry weights and state across from the reference package.

The reference's params and cache arrive as nested dicts / tuples / lists of
numpy arrays (the caller does `jax.tree.map(np.asarray, tree)`; this module
imports neither `jax` nor `ml_dtypes`). Conversion is leaf by leaf: same keys,
same shapes, no transposes — both packages use weights `[in, out]` as `x @ W`.

`flatten` / `unflatten` give the leaves in the order `jax.tree.flatten` gives
them (dict keys sorted, tuples and lists in sequence), because
`launch/serve.py` numbers the offload pages by that order.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch


def tensor_from_numpy(a, *, device, dtype=None) -> torch.Tensor:
    """One leaf, on `device` (no default: weights land where the caller says,
    never on the CPU by omission). numpy has no bfloat16: such a leaf arrives
    as an `ml_dtypes` array, recognised by its dtype's name, and goes through
    its 16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))      # a copy torch may own
    t = t.to(device)
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The way back for comparisons; bfloat16 is widened to float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def tree_map(fn, tree):
    """`fn` over every leaf of a nested dict / tuple / list, same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_numpy(tree, *, device, dtype=None):
    """The reference's params as the port's: every leaf a tensor on `device`;
    `dtype`, if given, is applied to floating leaves."""
    return tree_map(lambda a: tensor_from_numpy(a, device=device, dtype=dtype),
                    tree)


def cache_from_numpy(tree, *, device):
    """The reference's decode cache as the port's (types kept: bf16 K/V,
    int32 `len`)."""
    return tree_map(lambda a: tensor_from_numpy(a, device=device), tree)


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) with leaves in `jax.tree.flatten`'s order."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (tuple, list)):
            return (type(node).__name__, None, [walk(v) for v in node])
        leaves.append(node)
        return ("leaf", None, None)

    return leaves, walk(tree)


def unflatten(treedef, leaves):
    """Inverse of `flatten`."""
    it = iter(leaves)

    def build(node):
        kind, keys, children = node
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, children)}
        seq = [build(c) for c in children]
        return tuple(seq) if kind == "tuple" else seq

    return build(treedef)
