"""Parameter trees: nested dicts, lists and tuples of tensors, walked in
the JAX package's flatten order (dict keys sorted, lists and tuples in
order), so that a leaf's index means the same leaf on both sides (the
optimizer's global norm sums in that order; checkpoints name leaves by
it).  ``None`` is an empty node, as in JAX."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in flatten
    order) in place of its own."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}          # the caller's order
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                return type(node)(*vals)
            return type(node)(vals)
        return next(it)
    return build(like)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of ``tree``, in a tree of its structure."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def tree_leaves_like(like: Any, tree: Any) -> List[Any]:
    """``tree``'s leaves at ``like``'s leaf positions, ``None`` where
    ``tree`` holds ``None`` in place of a leaf (a gradient never
    computed)."""
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in tree_leaves_like(like[k], None if tree is None
                                          else tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for i, v in enumerate(like)
                for x in tree_leaves_like(v, None if tree is None
                                          else tree[i])]
    if like is None:
        return []
    return [tree]


def tree_structure(tree: Any) -> str:
    """The tree's structure as JAX prints it inside ``PyTreeDef(...)``:
    leaves as ``*``, dict keys sorted."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        o, c = ("[", "]") if isinstance(tree, list) else ("(", ")")
        return o + ", ".join(tree_structure(v) for v in tree) + c
    return "*"
