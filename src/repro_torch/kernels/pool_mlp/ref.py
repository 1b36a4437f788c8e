"""Plain PyTorch version of the fused pool-scoring kernel (Eq. 7 errors):
the Table-4 head MLP of every pool head as batched matrix products.  The
CPU path of the wrappers in ``ops.py``, and what ``chip_smoke.py`` holds the
CUDA kernel against on the card."""
from __future__ import annotations

import torch

from repro_torch.core.networks import head_pool_apply


def pool_errors_ref(pool_stacked, xd, y):
    """pool_stacked: head params stacked to (ns, ...); xd: (R, w); y: (R,).
    Returns (ns,) mean squared preliminary-prediction errors."""
    return torch.mean((y[None, :] - head_pool_apply(pool_stacked, xd)) ** 2,
                      dim=1)


def pool_errors_features_ref(pool_stacked, xd_feats, y):
    """xd_feats: (nf, R, w).  Returns (nf, ns): one row per target feature."""
    return torch.stack([pool_errors_ref(pool_stacked, xf, y)
                        for xf in xd_feats])
