"""Flash attention forward: CUDA kernel wrapper and its plain version.

Attention with an online softmax, causal (top-left: query row ``r`` sees
keys ``c <= r``) or full, fp32 accumulation and the output in the input
dtype (fp32 or bf16).  Three entry points, one kernel:

* :func:`flash_attention` — ``q, k, v: (B, H, T, D)`` with equal head
  counts, the layout of the TPU kernel ``repro/kernels/flash_attention.py::
  flash_attention``;
* :func:`gqa_flash_attention` — the same layout with ``Hq % Hkv == 0``,
  as ``repro/kernels/ops.py::gqa_flash_attention``, but query head ``h``
  reads kv head ``h // (Hq // Hkv)`` in place: kv is never repeated;
* :func:`flash_attention_bthd` — the model's ``(B, T, H, D)`` layout with
  GQA, the function ``repro/models/layers.py::flash_attention_xla``
  computes.

On CUDA tensors each launches ``csrc/flash_attention.cu`` (built for
``sm_90a`` at first use, see ``build.py``) on the current stream, or
raises; the source note there says what bounds it.  On CPU tensors each
runs :func:`attention_plain`, the same function in plain PyTorch (ported
from ``repro/kernels/ref.py::flash_attention`` with the top-left causal
mask of the kernel).  That is the only place the plain version stands in
for the kernel.

``launch_count`` counts kernel launches (never plain-version calls), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since import (or the last reset by the caller)
launch_count = 0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel in ``(B, H, T, D)`` layout:
    ``q (B, Hq, Tq, D)``, ``k, v (B, Hkv, Tk, D)``, ``Hq % Hkv == 0``.
    Scores in fp32 times ``sm_scale``, the top-left causal mask, softmax,
    and the product with ``v`` in fp32, cast back to ``q.dtype``."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Tq, D)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float()) * sm_scale
    if causal:
        rows = torch.arange(Tq, device=q.device)[:, None]
        cols = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(rows < cols, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return o.reshape(B, Hq, Tq, D).to(q.dtype)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load("flash_attention")
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [ci, ci, vp, vp, vp, vp] + [ci] * 5 + [ll] * 12
            + [ci, ctypes.c_float, vp])
        lib.flash_attention_launch.restype = ci
        lib.flash_attention_error_string.argtypes = [ci]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q, k, v, head_axis: int):
    """Shapes ``(B, Hq, Tq, D)`` / ``(B, Hkv, Tk, D)`` with the head axis
    at ``head_axis`` (1 or 2); returns ``(B, Hq, Hkv, Tq, Tk, D)``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want 4-d "
                         "q and equal k, v")
    t_axis = 3 - head_axis
    B, Hq, Tq, D = q.shape[0], q.shape[head_axis], q.shape[t_axis], q.shape[3]
    Hkv, Tk = k.shape[head_axis], k.shape[t_axis]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (batch, head_dim, or "
                         "q heads not a multiple of kv heads)")
    if Tk == 0 and Tq:
        raise ValueError("flash attention: no keys")
    return B, Hq, Hkv, Tq, Tk, D


def attention_cuda(q, k, v, *, causal: bool, sm_scale: float,
                   head_axis: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).
    ``head_axis`` 1: ``(B, H, T, D)`` tensors; 2: ``(B, T, H, D)``.  The
    output is contiguous in the same layout as ``q``."""
    global launch_count
    B, Hq, Hkv, Tq, Tk, D = _check(q, k, v, head_axis)
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype or t.stride(3) != 1:
            raise ValueError(f"flash attention kernel: {name} must be on "
                             f"{dev} in {q.dtype} with a contiguous last "
                             f"axis, got {t.dtype} on {t.device}, strides "
                             f"{t.stride()}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention kernel: dtype {q.dtype} (takes "
                         "float32 or bfloat16)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {D} (takes "
                         f"{HEAD_DIMS})")
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    if B * Hq * Tq == 0:
        return out
    t_axis = 3 - head_axis

    def bth(t):
        return t.stride(0), t.stride(t_axis), t.stride(head_axis)

    lib = _lib()
    rc = lib.flash_attention_launch(
        _DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, Tq, Tk, *bth(q), *bth(k), *bth(v),
        *bth(out), int(causal), float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    launch_count += 1
    return out


def _attend(q, k, v, causal, sm_scale, head_axis):
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kind = q.device.type
    if kind == "cuda":
        return attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale,
                              head_axis=head_axis)
    if kind != "cpu":
        raise NotImplementedError(f"flash attention on {kind!r} tensors")
    _check(q, k, v, head_axis)
    if head_axis == 1:
        return attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    t = lambda x: x.transpose(1, 2)
    return t(attention_plain(t(q), t(k), t(v), causal=causal,
                             sm_scale=sm_scale))


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None) -> torch.Tensor:
    """``q, k, v: (B, H, T, D)`` with equal head counts -> ``(B, H, Tq,
    D)``.  ``sm_scale`` defaults to ``1/sqrt(D)``."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"flash_attention takes equal head counts, got "
                         f"{q.shape[1]} and {k.shape[1]}; use "
                         "gqa_flash_attention")
    return _attend(q, k, v, causal, sm_scale, head_axis=1)


def gqa_flash_attention(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None) -> torch.Tensor:
    """``q: (B, Hq, T, D)``; ``k, v: (B, Hkv, T, D)`` with
    ``Hq % Hkv == 0``; kv heads are shared, not repeated."""
    return _attend(q, k, v, causal, sm_scale, head_axis=1)


def flash_attention_bthd(q, k, v, *, causal: bool = True,
                         sm_scale: float | None = None) -> torch.Tensor:
    """The model's layout: ``q: (B, Tq, Hq, D)``; ``k, v: (B, Tk, Hkv,
    D)`` -> ``(B, Tq, Hq, D)``."""
    return _attend(q, k, v, causal, sm_scale, head_axis=2)
