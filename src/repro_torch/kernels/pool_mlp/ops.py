"""Wrappers mapping the HeadPool's stacked param dict onto the Eq.-7
pool-scoring kernel.

A CUDA tensor goes to the CUDA kernel (``kernel.py``), which raises rather
than fall back; a CPU tensor goes to the plain version (``ref.py``).  Both
return +inf for non-finite scores (NaN probes, poisoned pool rows), so
argmin never selects them, and pass finite scores through unchanged.

``block_pool`` is the TPU kernel's pool-block size.  On the card each
thread block scores one head and a ragged pool needs no padding, so it has
no effect there; it is kept so that call sites read as in the reference."""
from __future__ import annotations

import torch

from repro_torch.kernels.pool_mlp import kernel as K
from repro_torch.kernels.pool_mlp.ref import pool_errors_features_ref

_KEYS = ("w0", "b0", "w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")


def _pin(errs: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(errs), errs, torch.inf)


def _sweep(pool_stacked, xd_feats, y, valid=None):
    if xd_feats.device.type != "cpu":
        return K.pool_mlp_features_cuda(
            xd_feats.contiguous(), y.contiguous(),
            tuple(pool_stacked[k].contiguous() for k in _KEYS), valid)
    errs = _pin(pool_errors_features_ref(pool_stacked, xd_feats, y))
    if valid is not None:
        errs = torch.where(valid[None, :], errs, torch.inf)
    return errs


def pool_mlp_errors(pool_stacked, xd, y, *, block_pool: int = 8):
    """pool_stacked: dict of stacked Table-4 head params (ns leading dim);
    xd: (R, w); y: (R,).  Returns (ns,) mean squared errors (Eq. 7)."""
    return _sweep(pool_stacked, xd[None], y)[0]


def pool_mlp_errors_features(pool_stacked, xd_feats, y, *,
                             block_pool: int = 8):
    """Score the whole pool against EVERY target feature's probe batch in
    one launch.  xd_feats: (nf, R, w); y: (R,).  Returns (nf, ns)."""
    return _sweep(pool_stacked, xd_feats, y)


def pool_mlp_errors_features_masked(pool_stacked, xd_feats, y, valid, *,
                                    block_pool: int = 8):
    """The padded union-pool sweep: rows that ``valid`` (ns,) bool marks
    invalid come back +inf.  Returns (nf, ns)."""
    return _sweep(pool_stacked, xd_feats, y, valid)


def pool_mlp_errors_shard(pool_chunk, xd_feats, y, valid=None, *,
                          block_pool: int = 8):
    """Score one contiguous CHUNK of the flattened pool.  A row's score
    depends on nothing but that row's params and the probe batch, and on
    the card each row is one thread block running the same code, so a chunk
    equals the same columns of the full sweep bit for bit.  valid: optional
    (chunk,) bool.  Returns (nf, chunk)."""
    return _sweep(pool_chunk, xd_feats, y, valid)
