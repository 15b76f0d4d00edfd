"""Nested containers of tensors (the reference's pytrees) in the reference's
order.

JAX flattens a dict by its sorted keys and a tuple or list in order, and
names a leaf by ``keystr`` (``[0]['opt']['m']['embed']``).  The optimizer
walks its trees, and the checkpoint writes them, in that order, so that a
checkpoint of either package names and numbers its leaves alike.  A leaf is
anything that is not a dict, tuple or list.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    raise TypeError(f"not a container: {type(tree).__name__}")


def is_leaf(x) -> bool:
    return not isinstance(x, (dict, tuple, list))


def leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(keystr, leaf)`` in the reference's flattening order."""
    if is_leaf(tree):
        yield prefix, tree
        return
    for key, child in _children(tree):
        yield from leaves_with_path(child, prefix + key)


def leaves(tree) -> list:
    return [x for _, x in leaves_with_path(tree)]


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure holding ``values`` in flattening order."""
    it = iter(values)

    def build(node):
        if is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(x) for x in node)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (which must hold ``tree``'s structure, or a prefix of it)."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return type(tree)(tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree))
