"""Carry weights and state across from the reference package.

The reference's params and cache arrive as nested dicts / tuples / lists of
numpy arrays (the caller does `jax.tree.map(np.asarray, tree)`; this module
imports neither `jax` nor `ml_dtypes`). Conversion is leaf by leaf: same keys,
same shapes, no transposes — both packages use weights `[in, out]` as `x @ W`.

`flatten` / `unflatten` give the leaves in the order `jax.tree.flatten` gives
them (dict keys sorted, tuples and lists in sequence), because
`launch/serve.py` numbers the offload pages by that order.
`flatten_with_path` adds each leaf's path string as
`jax.tree_util.keystr` writes it (`['scan'][0]['ffn']['w_gate']`): the
checkpoints name their leaves by it and the sharding rules classify them by
it.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

_FLOAT8 = {"float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}


def tensor_from_numpy(a, *, device, dtype=None) -> torch.Tensor:
    """One leaf, on `device` (no default: weights land where the caller says,
    never on the CPU by omission). numpy has no bfloat16 or float8: such a
    leaf arrives as an `ml_dtypes` array, recognised by its dtype's name,
    and goes through its bits (16 or 8). uint16 goes as it is."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    elif a.dtype.name in _FLOAT8:
        bits = np.ascontiguousarray(a).view(np.uint8).copy()
        t = torch.from_numpy(bits).view(_FLOAT8[a.dtype.name])
    else:
        t = torch.from_numpy(np.array(a))      # a copy torch may own
    t = t.to(device)
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The way back for comparisons; bfloat16 and float8 are widened to
    float32 (exactly: NaN and inf stay)."""
    t = t.detach().cpu()
    wide = t.dtype == torch.bfloat16 or t.dtype in _FLOAT8.values()
    return (t.float() if wide else t).numpy()


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


def _walk(node, leaves: List[Any]):
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_walk(node[k], leaves) for k in keys])
    if isinstance(node, (tuple, list)):
        return (type(node).__name__, None, [_walk(v, leaves) for v in node])
    leaves.append(node)
    return ("leaf", None, None)


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) with leaves in `jax.tree.flatten`'s order. Module
    functions, not a recursive closure: a closure that calls itself is a
    reference cycle, and it would hold every leaf until the cyclic garbage
    collector ran (the weights of a whole model, while they are stacked)."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def keystr_paths(tree, prefix: str = "") -> List[str]:
    """Path strings of the leaves, in flatten order, as
    `jax.tree_util.keystr` writes them: `['key']` for a dict key, `[i]` for
    a tuple or list index."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in keystr_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in keystr_paths(v, f"{prefix}[{i}]")]
    return [prefix]


def flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    """([(path, leaf)], treedef): `flatten` with each leaf's `keystr`
    path, as `jax.tree_util.tree_flatten_with_path` + `keystr` give them."""
    leaves, treedef = flatten(tree)
    return list(zip(keystr_paths(tree), leaves)), treedef


def _build(node, it):
    kind, keys, children = node
    if kind == "leaf":
        return next(it)
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(keys, children)}
    seq = [_build(c, it) for c in children]
    return tuple(seq) if kind == "tuple" else seq


def unflatten(treedef, leaves):
    """Inverse of `flatten`."""
    return _build(treedef, iter(leaves))
