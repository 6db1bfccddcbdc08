"""The (max,+) matrix product of the timing-readiness check.

:func:`maxplus_matmul` is ``repro/kernels/timing_check.py::maxplus_matmul``
(the Pallas kernel ``_maxplus_kernel``) on arbitrary operands:

    out[q, c] = max(-3e38, max_k T[q, k] + A[k, c])

in float32 for float32 or int32 inputs (int32 rounds to the nearest
float32, as ``astype(jnp.float32)`` does).  The accumulator starts at the
Pallas kernel's ``NEG`` (-3e38), so a row whose every term is -inf (say
-3e38 + -3e38) gives -3e38 there, where ``ref.maxplus_matmul`` gives
-inf; a padded k never raises a maximum, as the Pallas kernel's -3e38
padding (the sum overflows to -inf) does not.

On CUDA tensors it launches ``csrc/readiness.cu``'s (max,+) kernel (the
tile configuration planned by ``readiness.maxplus_plan`` from the shape
and the card's SM count; the Pallas ``bq``/``bk``/``bc`` block sizes have
no counterpart), or raises; on CPU tensors it runs the plain version
``readiness.maxplus_plain``.  Launches count in ``readiness.launch_count``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import readiness as R

NEG = -3e38


def maxplus_matmul(T: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``out[q, c] = max_k T[q, k] + A[k, c]``, float32 in and out (int32
    inputs are cast), ``(Q, K) x (K, C) -> (Q, C)``."""
    if T.dim() != 2 or A.dim() != 2 or T.shape[1] != A.shape[0]:
        raise ValueError(f"maxplus_matmul: shapes {tuple(T.shape)} x "
                         f"{tuple(A.shape)} do not chain")
    if T.device != A.device:
        raise ValueError(f"maxplus_matmul: T on {T.device}, A on "
                         f"{A.device}")
    T = T.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    kind = T.device.type
    if kind == "cuda":
        return R.maxplus_cuda(T, A, NEG)
    if kind == "cpu":
        return R.maxplus_plain(T, A, NEG)
    raise NotImplementedError(f"maxplus_matmul on {kind!r} tensors")
