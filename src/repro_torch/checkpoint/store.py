"""Checkpointing (port of ``repro/checkpoint/store.py``): a tree of
tensors <-> sharded ``.npz`` files, on the reference's layout, so that a
checkpoint written by either package loads in the other.

Layout: ``<dir>/step_<%08d>/part_<i>.npz`` holding arrays named
``leaf_<i>``, plus ``manifest.json`` with ``n_leaves``, ``index`` (leaf
name -> part) and ``treedef``, the string JAX prints for the tree's
structure (``PyTreeDef({...})``), which ``restore_checkpoint`` holds
against the target's.  Leaves go in JAX's flatten order
(``tree.tree_leaves``: dict keys sorted, lists and tuples in order).
Parts stay under ``max_bytes_per_part``.  bf16 leaves are written as the
reference's ``np.savez`` writes ``ml_dtypes.bfloat16`` arrays: raw
2-byte ``|V2`` records.  Reading one back into a bf16 leaf reinterprets those bits as
bfloat16, so the port reads the reference's bf16 checkpoints bit for bit
(the reference's own ``restore_checkpoint`` cannot cast ``|V2``)."""
from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_structure, tree_unflatten

_BF16_RECORD = np.dtype("V2")


def _treedef(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts,
    lists, tuples and ``None``."""
    return f"PyTreeDef({tree_structure(tree)})"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _to_torch(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s type and device: 2-byte records
    are bf16 bits; anything else is cast as the reference casts."""
    if arr.dtype == _BF16_RECORD:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save_checkpoint(directory: str, step: int, tree,
                    max_bytes_per_part: int = 512 * 1024 * 1024) -> str:
    """Write ``tree``'s leaves (tensors, copied to the host) under
    ``directory/step_<step>``; returns that path."""
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    named = [(f"leaf_{i}", _to_numpy(x))
             for i, x in enumerate(tree_leaves(tree))]
    parts: List[List[Tuple[str, np.ndarray]]] = [[]]
    size = 0
    for name, arr in named:
        if size + arr.nbytes > max_bytes_per_part and parts[-1]:
            parts.append([])
            size = 0
        parts[-1].append((name, arr))
        size += arr.nbytes
    index = {}
    for i, group in enumerate(parts):
        np.savez(os.path.join(path, f"part_{i}.npz"), **dict(group))
        for name, _ in group:
            index[name] = i
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"n_leaves": len(named), "index": index,
                   "treedef": _treedef(tree)}, f)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The highest ``step_<n>`` under ``directory``, or ``None``."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", d))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like):
    """Restore into the structure, types and devices of ``like``
    (validates the structure, the leaf count and every leaf's shape)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = tree_leaves(like)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target tree has {len(leaves)}")
    if manifest["treedef"] != _treedef(like):
        raise ValueError(f"checkpoint structure {manifest['treedef']} != "
                         f"target's {_treedef(like)}")
    files = {}
    out = []
    try:
        for i, ref in enumerate(leaves):
            name = f"leaf_{i}"
            part = manifest["index"][name]
            if part not in files:
                files[part] = np.load(os.path.join(path, f"part_{part}.npz"))
            arr = files[part][name]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{name} shape {arr.shape} != "
                                 f"{tuple(ref.shape)}")
            out.append(_to_torch(arr, ref))
    finally:
        for f in files.values():
            f.close()
    return tree_unflatten(like, out)
