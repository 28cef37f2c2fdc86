"""Parameter trees: nested dicts of tensors, walked with their keys in
sorted order at every level, the order in which ``jax.tree`` flattens a
dict (so sums over leaves, and checkpoint keys, follow the reference's)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

__all__ = ["tree_leaves", "tree_map", "tree_map_paths", "tree_at"]


def tree_leaves(tree: Any) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs of a nested dict, keys sorted at every
    level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in tree_leaves(tree[k]):
                yield (k,) + path, leaf
    else:
        yield (), tree


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """The same nested dicts with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_map_paths(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                   pre: Tuple[str, ...] = ()) -> Any:
    """The same nested dicts with ``fn(path, leaf)`` at every leaf."""
    return {k: (tree_map_paths(fn, v, pre + (k,)) if isinstance(v, dict)
                else fn(pre + (k,), v)) for k, v in tree.items()}


def tree_at(tree: Any, path: Tuple[str, ...]) -> Any:
    """The node of ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree
