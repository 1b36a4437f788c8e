"""Carry parameter trees between the JAX package and the port.

The JAX package's parameters, as nested dicts of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``), become the port's tensors
key for key, so both packages compute the same function on the same
weights."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._tree import tree_map


def params_from_numpy(tree, device="cpu"):
    """Nested dict of arrays -> nested dict of tensors on ``device``.  Values
    are copied, so the result shares no memory with the arrays."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def params_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
