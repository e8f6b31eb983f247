"""Parameter trees as nested dicts, walked in the JAX package's leaf order.

The reference keeps params, gradients, optimizer moments and compression
state as pytrees of nested dicts, and ``jax.tree.flatten`` visits dict
keys in sorted order, depth first.  Leaf order is part of the contract:
``init_compression`` folds a leaf's index in that order into its hash key,
so the port walks its trees the same way and a leaf index names the same
leaf in both packages.  Paths are tuples of dict keys, e.g. ``("blocks",
"layer_0", "attn", "wq")``.

Only dicts are inner nodes here; anything else (a tensor, ``None``, a
NamedTuple such as ``Moment8``, a ``LeafCompressor``) is a leaf.  The
reference treats ``None`` as an empty subtree; keeping it as a leaf lets a
state tree with passthrough ``None``s line up with its param tree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[str, ...]


def flatten(tree: Any) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in ``jax.tree.flatten``'s order (sorted keys,
    depth first)."""
    out: List[Tuple[Path, Any]] = []
    _walk(tree, (), out)
    return out


def _walk(node: Any, path: Path, out: List[Tuple[Path, Any]]) -> None:
    # A module-level walk, not a closure: a nested function that calls
    # itself holds its own cell, and that cycle kept every flattened tree's
    # leaves (a train step's params, gradients and moments) alive until
    # Python's cyclic collector ran.
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], path + (key,), out)
    else:
        out.append((path, node))


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(pairs) -> Dict[str, Any]:
    """The nested dict holding each (path, leaf) of ``pairs``."""
    root: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return root


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Dict[str, Any]:
    """``fn`` applied to every leaf of ``tree``."""
    return unflatten((path, fn(leaf)) for path, leaf in flatten(tree))
