"""Weight bridge: a parameter pytree given as numpy arrays -> the port's
parameters.

The JAX package's ``TransformerLM.init`` returns nested dicts (and
lists) of arrays; ``np.asarray`` of each leaf gives numpy arrays, bf16
leaves as ``ml_dtypes.bfloat16``.  ``to_torch`` maps that tree leaf by
leaf to tensors on a device, keeping the layout (the periodic blocks'
leaves stay stacked on their leading layer axis, which is the port's
layout too).  It also moves a tree of tensors between devices.  This
module imports no JAX: the caller does the ``np.asarray``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def leaf_to_torch(a, device) -> torch.Tensor:
    """One leaf: a tensor is moved; a numpy array (bf16 included) is
    copied to ``device`` bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: go through the bits
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def to_torch(tree: Any, device) -> Any:
    """Map a nested dict/list/tuple of arrays or tensors to tensors on
    ``device``, keeping the structure."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return leaf_to_torch(tree, device)
