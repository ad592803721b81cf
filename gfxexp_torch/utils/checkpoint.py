"""Checkpoint and resume of trees of tensors (port of
gfxexp_tpu/utils/checkpoint.py): NRC's optimizer state, film
accumulation, reservoirs.

Format: a numpy .npz of the leaves (`leaf_0`, `leaf_1`, ...) and a JSON
manifest of the tree's structure, never pickle: loading a checkpoint
executes no code. A tree is a nested dict, list or tuple of tensors (dict
keys in sorted order). load_checkpoint checks the structure, the shapes
and the dtypes against a `like` template and puts each leaf on its
template's device.
"""

from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np
import torch

from gfxexp_torch.core.tree import tree_flatten, tree_unflatten

_MANIFEST_KEY = "__treedef_json__"


def _describe(structure) -> str:
    return json.dumps(structure, sort_keys=True)


def save_checkpoint(path: str, tree: Any) -> None:
    leaves, structure = tree_flatten(tree)
    arrays = {f"leaf_{i}": torch.as_tensor(x).detach().cpu().numpy()
              for i, x in enumerate(leaves)}
    arrays[_MANIFEST_KEY] = np.frombuffer(json.dumps(
        {"treedef": _describe(structure), "n": len(leaves)}).encode(),
        dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_checkpoint(path: str, like: Optional[Any] = None) -> Any:
    """The tree saved by save_checkpoint. `like` gives the structure
    (required unless the checkpoint holds one leaf), each leaf's device,
    and the shapes and dtypes the leaves must have."""
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(bytes(data[_MANIFEST_KEY]).decode())
        n = manifest["n"]
        leaves = [torch.from_numpy(np.array(data[f"leaf_{i}"]))
                  for i in range(n)]
    if like is None:
        if n == 1:
            return leaves[0]
        raise ValueError(
            f"checkpoint {path} has {n} leaves; pass `like` to restore the "
            f"tree structure (stored structure: {manifest['treedef']})")
    like_leaves, structure = tree_flatten(like)
    if manifest["treedef"] != _describe(structure):
        raise ValueError(
            f"checkpoint structure mismatch: {path} holds "
            f"{manifest['treedef']}, expected {_describe(structure)}")
    out = []
    for i, (x, ref) in enumerate(zip(leaves, like_leaves)):
        ref = torch.as_tensor(ref)
        if x.shape != ref.shape or x.dtype != ref.dtype:
            raise ValueError(
                f"checkpoint leaf {i} of {path} is {x.dtype} "
                f"{tuple(x.shape)}, expected {ref.dtype} {tuple(ref.shape)}")
        out.append(x.to(ref.device))
    return tree_unflatten(structure, out)
