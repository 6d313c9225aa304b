"""Nested dicts, lists and tuples of tensors (the port's parameter and
optimizer trees), walked in one fixed order: dict insertion order, then
list order.  ``None`` is an empty subtree, as in JAX."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure), rebuilt in ``tree``'s nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):  # a NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, is_leaf=None, path=()):
    """``fn(path, leaf)`` over the leaves of ``tree`` (and over the nodes
    for which ``is_leaf`` holds), rebuilt in its nesting; a path is the
    tuple of dict keys, sequence indices and NamedTuple field names from
    the root (JAX's key path)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, is_leaf, path + (k,))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(tree_map_with_path(fn, v, is_leaf, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, is_leaf, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def map_subtrees(pred, fn, tree):
    """Rebuild ``tree`` with ``fn(node)`` in place of every outermost node
    for which ``pred(node)`` holds (the others walked as in
    :func:`tree_map`, leaves kept)."""
    if pred(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_subtrees(pred, fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [map_subtrees(pred, fn, v) for v in tree]
        if hasattr(tree, "_fields"):  # a NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    return tree


def subtrees(pred, tree) -> list:
    """The outermost nodes of ``tree`` for which ``pred`` holds, in
    :func:`tree_map`'s order."""
    out = []
    map_subtrees(pred, lambda node: out.append(node) or node, tree)
    return out
