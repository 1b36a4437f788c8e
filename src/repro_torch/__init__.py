"""PyTorch/CUDA port of the HFL system (the JAX package ``repro`` is the
reference it is held against).

Entry points take a ``device`` that defaults to ``"cuda"`` and raise when
no card is present; the CPU runs only when a caller asks for it
(``device="cpu"``), as the tests do.  Hand-written kernels live under
``csrc/`` and are built with ``nvcc`` at their first launch
(see :mod:`repro_torch._build`).
"""
import torch

# Eq.-7 selection identity between the kernel and its plain version, and
# between the port and the reference, needs full fp32 products: TF32 keeps
# about three decimal digits, enough to flip an argmin between close heads.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
