"""Nested dict/list parameter trees: the port's stand-in for jax pytrees.

Order and path strings follow ``jax.tree_util``: dict keys in sorted order,
list entries by index, paths joined with "/" ("blocks/0/attn/wq"), so a
bucket plan built from these paths matches the reference's exactly.
"""

from __future__ import annotations

from typing import Any, Callable


def _children(tree: Any):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree: Any) -> dict[str, Any]:
    """Flatten a tree into an insertion-ordered ``{"a/b/0": leaf}`` dict,
    in jax's leaf order."""
    flat: dict[str, Any] = {}

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            flat[prefix] = node
            return
        for k, v in kids:
            walk(v, f"{prefix}/{k}" if prefix else k)

    walk(tree, "")
    return flat


def leaves(tree: Any) -> list[Any]:
    return list(flatten_with_paths(tree).values())


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Map ``fn`` over the leaves, keeping the dict/list structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten_like(template: Any, new_leaves: list[Any]) -> Any:
    """Rebuild ``template``'s structure with ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
