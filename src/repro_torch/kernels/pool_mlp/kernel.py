"""ctypes binding of the CUDA Eq.-7 pool-scoring kernel
(``csrc/pool_mlp.cu``, the counterpart of the TPU kernel
``repro.kernels.pool_mlp.kernel._pool_kernel``).

:func:`pool_mlp_features_cuda` checks its inputs, allocates the output,
launches on the current stream of the tensors' device and raises if the
launch was refused.  ``launches`` counts the launches it made."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch import _build

launches = 0

_HIDDEN = (16, 256, 64, 16, 1)
_MAX_SMEM = 232448            # H100 / H200: the most one block may use


def _lib() -> ctypes.CDLL:
    lib = _build.load("pool_mlp")
    fn = lib.pool_mlp_errors_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.pool_mlp_smem_bytes.argtypes = [ctypes.c_int]
        lib.pool_mlp_smem_bytes.restype = ctypes.c_longlong
        lib.pool_mlp_error_string.argtypes = [ctypes.c_int]
        lib.pool_mlp_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pool_mlp_features_cuda(xd_feats: torch.Tensor, y: torch.Tensor,
                           weights: Sequence[torch.Tensor],
                           valid: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """xd_feats: (nf, R, w); y: (R,); weights: (w0, b0, ..., w4, b4) of the
    stacked Table-4 heads, each with leading pool dim ns; valid: optional
    (ns,) bool.  All contiguous fp32 (bool) CUDA tensors on one device.
    Returns (nf, ns) errors, +inf where non-finite or invalid."""
    global launches
    device = xd_feats.device
    if device.type != "cuda":
        raise ValueError(f"pool_mlp_features_cuda needs CUDA tensors, "
                         f"got {device}")
    if xd_feats.dim() != 3:
        raise ValueError(f"xd_feats must be (nf, R, w), "
                         f"got {tuple(xd_feats.shape)}")
    nf, R, w = xd_feats.shape
    if R < 1:
        raise ValueError("the probe batch is empty (R=0)")
    if len(weights) != 10:
        raise ValueError(f"expected 10 weight tensors, got {len(weights)}")
    ns = weights[0].shape[0]
    _check("xd_feats", xd_feats, (nf, R, w), device)
    _check("y", y, (R,), device)
    dims = (w,) + _HIDDEN
    for i in range(5):
        _check(f"w{i}", weights[2 * i], (ns, dims[i], dims[i + 1]), device)
        _check(f"b{i}", weights[2 * i + 1], (ns, dims[i + 1]), device)
    if valid is not None:
        _check("valid", valid, (ns,), device, torch.bool)
    out = torch.empty((nf, ns), dtype=torch.float32, device=device)
    if nf == 0 or ns == 0:
        return out
    lib = _lib()
    smem = lib.pool_mlp_smem_bytes(w)
    if smem > _MAX_SMEM:
        raise ValueError(f"probe width w={w} needs {smem} bytes of shared "
                         f"memory per block, more than {_MAX_SMEM}")
    stream = torch.cuda.current_stream(device).cuda_stream
    code = lib.pool_mlp_errors_f32(
        xd_feats.data_ptr(), y.data_ptr(),
        *(t.data_ptr() for t in weights),
        valid.data_ptr() if valid is not None else None,
        out.data_ptr(), nf, ns, R, w, device.index or 0, stream)
    if code:
        raise RuntimeError(f"pool_mlp kernel launch failed: "
                           f"{lib.pool_mlp_error_string(code).decode()}")
    launches += 1
    return out
