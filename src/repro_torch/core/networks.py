"""Paper networks (Table 4) on PyTorch tensors.

Table 4 exact layer widths:
  Head H:        Linear 16 - Sigmoid - Linear 256 - Sigmoid - Linear 64 -
                 LReLU - Linear 16 - LReLU - Linear 1
  Embedding E:   same trunk, final Linear w
  Prediction P:  Linear 32 - Sigmoid - Linear 256 - Sigmoid - Linear 16 -
                 LReLU - Linear 1 - LReLU - Linear 1

Parameters are dicts of tensors keyed like ``repro.core.networks``'
pytrees (``w0``/``b0`` ... per layer; ``heads`` stacked over features), so
weights carry across key for key.  The benchmark systems (DNN, BIBE) are
not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.sharding.spec import ParamSpec, stack

LRELU_SLOPE = 0.01


def _mlp_schema(dims: Sequence[int]):
    layers = {}
    for i in range(len(dims) - 1):
        layers[f"w{i}"] = ParamSpec((dims[i], dims[i + 1]), (None, None))
        layers[f"b{i}"] = ParamSpec((dims[i + 1],), (None,), init="zeros")
    return layers


def _mlp_apply(params, x, acts: Sequence[str]):
    """x: (..., d_in).  Weights may carry one leading stack dim (a pool or
    the nf heads): ``w`` (S, d_in, d_out) then broadcasts against x of shape
    (R, d_in) or (S, R, d_in) and each bias is added per stack entry."""
    n = len(acts) + 1
    for i in range(n):
        w, b = params[f"w{i}"], params[f"b{i}"]
        x = x @ w + (b.unsqueeze(-2) if w.dim() == 3 else b)
        if i < len(acts):
            if acts[i] == "sigmoid":
                x = torch.sigmoid(x)
            elif acts[i] == "lrelu":
                x = torch.where(x >= 0, x, LRELU_SLOPE * x)
    return x


# ---------------------------------------------------------------------------
# HFL component networks (Table 4)
# ---------------------------------------------------------------------------

_H_ACTS = ("sigmoid", "sigmoid", "lrelu", "lrelu")


def head_schema(w: int):
    """Global head H_i: dense feature vector (w,) -> scalar preliminary y'."""
    return _mlp_schema((w, 16, 256, 64, 16, 1))


def head_apply(params, xd):
    """xd: (..., w) -> (...,)."""
    return _mlp_apply(params, xd, _H_ACTS)[..., 0]


def head_pool_apply(pool_stacked, xd):
    """Apply every head of a stacked pool to one probe batch as batched
    matrix products.  pool_stacked: head params with a leading pool dim
    (ns, ...); xd: (R, w).  Returns (ns, R) preliminary predictions."""
    return _mlp_apply(pool_stacked, xd, _H_ACTS)[..., 0]


def embed_schema(nf: int, w: int):
    """Local embedding E: sparse tensor (nf*w,) -> temporal embedding (w,)."""
    return _mlp_schema((nf * w, 16, 256, 64, 16, w))


def embed_apply(params, xs_flat):
    return _mlp_apply(params, xs_flat, _H_ACTS)


def pred_schema(nf: int, w: int):
    """Prediction P: [y'_1..y'_nf, e] (nf+w,) -> scalar y'."""
    return _mlp_schema((nf + w, 32, 256, 16, 1, 1))


def pred_apply(params, z):
    return _mlp_apply(params, z, _H_ACTS)[..., 0]


def hfl_schema(nf: int, w: int):
    return {
        "heads": stack(head_schema(w), nf),     # stacked over features
        "embed": embed_schema(nf, w),
        "pred": pred_schema(nf, w),
    }


def hfl_forward(params, xs, xd):
    """xs, xd: (B, nf, w).  Returns (y_final (B,), y_prelim (B, nf))."""
    # head f reads feature f: (nf, B, w) against the (nf, ...) stacked heads
    y_prelim = head_pool_apply(params["heads"], xd.transpose(0, 1)).T
    e = embed_apply(params["embed"], xs.reshape(xs.shape[0], -1))  # (B, w)
    z = torch.cat([y_prelim, e], dim=-1)
    y = pred_apply(params["pred"], z)
    return y, y_prelim


def hfl_loss(params, xs, xd, y):
    """Multi-task MSE (Eqs. 3 & 6): final + nf preliminary tasks."""
    y_hat, y_prelim = hfl_forward(params, xs, xd)
    final = torch.mean((y - y_hat) ** 2)
    prelim = torch.mean(torch.sum((y[:, None] - y_prelim) ** 2, dim=-1))
    return final + prelim, (final, prelim)
