"""Parameter schema machinery: a tree of :class:`ParamSpec` leaves describes
shape and initializer, and :func:`materialize` turns it into tensors.

Counterpart of ``repro.sharding.spec`` without its PartitionSpec and
abstract-lowering parts.  The fan-in truncated normal follows the same law
(spec.py:59-63 of the reference) but draws from ``torch.Generator``s, so the
numbers differ from JAX's for the same seed: a test that needs equal
parameters carries them across with :mod:`repro_torch.convert`."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map, tree_paths

Logical = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: Tuple[int, ...]
    logical: Logical
    init: str = "fan_in"  # fan_in | zeros (what the HFL networks use)
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(
                f"shape {self.shape} and logical axes {self.logical} rank mismatch")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _init_leaf(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype)
    if spec.init == "fan_in":
        # truncated-normal with stddev 1/sqrt(fan_in); fan_in = prod of all but last dim
        fan_in = max(1, int(np.prod(spec.shape[:-1])) if len(spec.shape) > 1 else spec.shape[0])
        t = torch.empty(spec.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (spec.scale / math.sqrt(fan_in) * t).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def _path_hash(path: str) -> int:
    """FNV-1a over the leaf's path string, the reference's per-path fold."""
    h = 2166136261
    for ch in path:
        h = ((h ^ ord(ch)) * 16777619) & 0x7FFFFFFF
    return h


def materialize(schema, seed: int, device="cpu"):
    """Instantiate a schema tree into tensors on ``device``.  Each leaf draws
    from its own CPU generator seeded by ``(seed, path)``, so a leaf's values
    depend on nothing but the seed and its path, and are the same on every
    device."""
    paths = iter(tree_paths(schema))

    def leaf(spec):
        assert is_spec(spec), f"non-spec leaf: {spec}"
        gen = torch.Generator().manual_seed(
            (int(seed) * 2654435761 + _path_hash(next(paths))) % (1 << 63))
        return _init_leaf(spec, gen).to(device)

    return tree_map(leaf, schema)


def stack(schema, n: int, axis_name: Optional[str] = None):
    """Prepend a stacking dimension (heads stacked over features)."""
    return tree_map(lambda spec: ParamSpec((n,) + spec.shape,
                                           (axis_name,) + spec.logical,
                                           spec.init, spec.scale, spec.dtype),
                    schema)


def count_params(schema) -> int:
    return sum(s.size for s in tree_leaves(schema) if is_spec(s))
