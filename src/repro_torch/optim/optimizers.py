"""Adam as in ``repro.optim.optimizers``, term for term.

``update`` computes ``-lr * (m / bc1) / (sqrt(v / bc2) + eps)`` with the
bias corrections taken from the incremented step counter and the learning
rate from the step before it (optimizers.py:89-113 of the reference), all
in fp32.  ``torch.optim.Adam`` folds the same terms in another order and
rounds differently, so it is not used."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {"step": 0,
                "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                              params),
                "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                              params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        # The reference evaluates b ** step in fp32.  The corrections stay
        # 0-dim tensors on the gradients' device: CUDA divides by a CPU
        # scalar as a product with its reciprocal, one rounding off the
        # reference's quotient.
        f32 = torch.float32
        s = torch.tensor(step, dtype=f32)
        dev = tree_leaves(grads)[0].device
        bc1 = (1.0 - torch.tensor(b1, dtype=f32) ** s).to(dev)
        bc2 = (1.0 - torch.tensor(b2, dtype=f32) ** s).to(dev)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(f32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.to(f32) * g.to(f32),
                     state["v"], grads)
        ref = params if params is not None else m
        upd = tree_map(
            lambda m_, v_, p: (-lr * (m_ / bc1)
                               / (torch.sqrt(v_ / bc2) + eps)).to(p.dtype),
            m, v, ref)
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
