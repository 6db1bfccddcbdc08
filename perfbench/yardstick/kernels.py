"""Kernel names by kind, as cuBLAS names its GEMM kernels on the H100.

cuBLAS 12 names its Hopper GEMMs ``nvjet_<a><c><d>_...``: the letters
give the types of the operands, the compute and the output (``t``
bf16, ``s`` fp32, ``h`` fp16), so ``nvjet_tst`` is a bf16 product with
fp32 accumulation and ``nvjet_sss`` a full fp32 one.  Older kernels carry
the types in the name (``gemm_bf16...``, ``sgemm``, ``gemm_f32f32``).
"""
from __future__ import annotations

import re

_NVJET = re.compile(r"nvjet_([a-z])([a-z])([a-z])_")


def _nvjet_types(name: str):
    m = _NVJET.search(name)
    return m.groups() if m else None


def is_gemm(name: str) -> bool:
    return _nvjet_types(name) is not None or any(
        s in name for s in ("gemm", "gemv", "xmma_", "cutlass"))


def bf16_gemm(name: str) -> bool:
    t = _nvjet_types(name)
    if t is not None:
        return t[0] == "t"
    return is_gemm(name) and "bf16" in name


def fp32_gemm(name: str) -> bool:
    t = _nvjet_types(name)
    if t is not None:
        return t == ("s", "s", "s")
    return is_gemm(name) and ("sgemm" in name or "f32f32_f32f32" in name
                              or "gemv2T_kernel_val<int, int, float" in name
                              or "gemvNSP_kernel<float" in name)
