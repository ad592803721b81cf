"""Nested dicts, lists and tuples of tensors as trees: flatten, rebuild and
map, with dict keys in sorted order as JAX's tree utilities take them (so a
port's tree flattens in the same leaf order as the JAX package's)."""

from __future__ import annotations


def tree_flatten(tree):
    """(leaves, structure): the leaves depth first, dict keys sorted; the
    structure is a nested description of the containers with `None` for
    each leaf position (printable and comparable)."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_unflatten(structure, leaves):
    """The tree of `structure` with its leaf positions filled from
    `leaves` in order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(structure)


def tree_leaves(tree):
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the matching leaves of `rest`,
    which must have the same structure)."""
    leaves, structure = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(structure,
                          [fn(*xs) for xs in zip(leaves, *others)])
