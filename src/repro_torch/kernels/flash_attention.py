"""Flash attention forward: CUDA kernel wrappers and their plain version.

Attention with an online softmax, causal (top-left: query row ``r`` sees
keys ``c <= r``) or full, fp32 accumulation and the output in the input
dtype (fp32 or bf16).  Three entry points, two kernels:

* :func:`flash_attention` — ``q, k, v: (B, H, T, D)`` with equal head
  counts, the layout of the TPU kernel ``repro/kernels/flash_attention.py::
  flash_attention``;
* :func:`gqa_flash_attention` — the same layout with ``Hq % Hkv == 0``,
  as ``repro/kernels/ops.py::gqa_flash_attention``, but query head ``h``
  reads kv head ``h // (Hq // Hkv)`` in place: kv is never repeated;
* :func:`flash_attention_bthd` — the model's ``(B, T, H, D)`` layout with
  GQA, the function ``repro/models/layers.py::flash_attention_xla``
  computes.

On CUDA tensors each launches one of two kernels on the current stream
(built for ``sm_90a`` at first use, see ``build.py``), or raises; the
source notes say what bounds each.  :func:`route` picks the kernel from
the dtype and head dim alone:

* ``"sm90"`` — ``csrc/flash_attention_sm90.cu``, the tensor-core kernel
  (``wgmma``, TMA, ``mbarrier`` ring) for bf16 at D 64 and 128.  TMA needs
  a 16-byte aligned base and 16-byte multiples for every stride:
  :func:`sm90_plan` checks them and raises on anything else;
* ``"cuda_core"`` — ``csrc/flash_attention.cu`` for bf16 at D 16 and 32
  (on the tensor cores, ``mma.sync``) and fp32 at any D (on the CUDA
  cores: tensor-core TF32 would miss fp32's 2e-5), one block per 64-row
  q tile.

A case a kernel takes always goes to it: a failed build or launch raises
and never falls back to the other kernel or to the plain version.  On CPU
tensors each entry point runs :func:`attention_plain`, the same function
in plain PyTorch (ported from ``repro/kernels/ref.py::flash_attention``
with the top-left causal mask of the kernels).  That is the only place the
plain version stands in for a kernel.

``launch_count`` (the CUDA-core kernel) and ``sm90_launch_count`` count
kernel launches (never plain-version calls), so a run can show which
kernel served its main path.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: what the tensor-core kernel takes: bf16 at these head dims
SM90_HEAD_DIMS = (64, 128)
#: its q tile and kv tile rows, the rows of output one consumer
#: warpgroup stores (the TMA box heights), and the box width
SM90_BLOCK_Q = 128
SM90_BLOCK_K = 128
SM90_STORE_ROWS = 64
SM90_BOX_COLS = 64

#: "cuda_core" kernel launches since import (or the last reset by the
#: caller)
launch_count = 0
#: tensor-core (sm90) kernel launches, counted the same way
sm90_launch_count = 0


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


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves ``dtype`` at ``head_dim`` on the card:
    ``"sm90"`` for bf16 at D 64 or 128, else ``"cuda_core"``.  The layout
    does not enter: both layouts and strided views go to the same kernel
    (or raise, if TMA cannot take their alignment)."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    return "cuda_core"


class TmaGeometry(NamedTuple):
    """One tensor as the sm90 kernel's TMA sees it: a 4-d tensor with
    global dims ``(D, T, H, B)`` (innermost first), byte strides of the
    outer three ``(t, h, b)``, a box of ``(box_cols, box_rows, 1, 1)``
    elements, and ``n_boxes`` boxes across D (a 128-byte swizzled box is at
    most 64 bf16 wide)."""
    dims: tuple
    strides: tuple
    box_rows: int
    box_cols: int
    n_boxes: int

    def packed(self) -> tuple:
        """The 8 values the C launcher reads: dims, strides, box rows."""
        return (*self.dims, *self.strides, self.box_rows)


def tma_geometry(t: torch.Tensor, head_axis: int, box_rows: int,
                 name: str = "tensor") -> TmaGeometry:
    """The TMA geometry of ``t`` (``(B, H, T, D)`` with ``head_axis`` 1 or
    ``(B, T, H, D)`` with ``head_axis`` 2, any strides with D contiguous).
    Raises ``ValueError`` unless the base address is 16-byte aligned and
    every stride of an axis longer than 1 is a multiple of 16 bytes (an
    axis of length 1 is never stepped, so its stride is replaced).  Runs
    on every launch, so it reads the shape and strides once."""
    shape, stride, es = t.shape, t.stride(), t.element_size()
    D = shape[3]
    if stride[3] != 1 or D % SM90_BOX_COLS:
        raise ValueError(f"sm90 flash attention: {name} needs a contiguous "
                         f"head dim that is a multiple of {SM90_BOX_COLS}, "
                         f"got shape {tuple(shape)}, strides {stride}")
    if t.data_ptr() % 16:
        raise ValueError(f"sm90 flash attention: {name}'s base address is "
                         f"not 16-byte aligned (TMA needs it): "
                         f"{t.data_ptr():#x}")
    axes = (3 - head_axis, head_axis, 0)
    dims = (D, shape[axes[0]], shape[axes[1]], shape[0])
    strides = []
    for ax, n in zip(axes, dims[1:]):
        st = stride[ax] * es if n != 1 else D * es
        if st % 16 or st <= 0:
            raise ValueError(f"sm90 flash attention: {name}'s stride along "
                             f"axis {ax} is {st} bytes; TMA needs a positive "
                             "multiple of 16")
        strides.append(st)
    return TmaGeometry(dims, tuple(strides), box_rows, SM90_BOX_COLS,
                       D // SM90_BOX_COLS)


def sm90_plan(q, k, v, out, head_axis: int):
    """The TMA geometries ``(q, k, v, out)`` the sm90 kernel is launched
    with: q in boxes of ``SM90_BLOCK_Q`` rows, k and v of
    ``SM90_BLOCK_K``, the output stored in boxes of ``SM90_STORE_ROWS``."""
    return (tma_geometry(q, head_axis, SM90_BLOCK_Q, "q"),
            tma_geometry(k, head_axis, SM90_BLOCK_K, "k"),
            tma_geometry(v, head_axis, SM90_BLOCK_K, "v"),
            tma_geometry(out, head_axis, SM90_STORE_ROWS, "out"))


_LIBS: dict = {}


def _lib(name: str):
    lib = _LIBS.get(name)
    if lib is None:
        from repro_torch.kernels import build
        lib = build.load(name)
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "flash_attention":
            fn = lib.flash_attention_launch
            err = lib.flash_attention_error_string
            fn.argtypes = ([ci, ci, vp, vp, vp, vp] + [ci] * 5 + [ll] * 12
                           + [ci, ctypes.c_float, ci, vp])
        else:
            fn, err = lib.flash_sm90_launch, lib.flash_sm90_error_string
            fn.argtypes = ([ci, vp, vp, vp, vp] + [ci] * 5
                           + [ctypes.POINTER(ctypes.c_ulonglong), ci,
                              ctypes.c_float, vp])
        fn.restype = ci
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


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
    """Launch the kernel :func:`route` picks on the current stream (no
    synchronise).  ``head_axis`` 1: ``(B, H, T, D)`` tensors; 2: ``(B, T,
    H, D)``.  The output is contiguous in the same layout as ``q``."""
    global launch_count, sm90_launch_count
    B, Hq, Hkv, Tq, Tk, D = _check(q, k, v, head_axis)
    dev = q.device
    strides = [t.stride() for t in (q, k, v)]
    for name, t, st in zip("qkv", (q, k, v), strides):
        if t.device != dev or t.dtype != q.dtype or st[3] != 1:
            raise ValueError(f"flash attention kernel: {name} must be on "
                             f"{dev} in {q.dtype} with a contiguous last "
                             f"axis, got {t.dtype} on {t.device}, strides "
                             f"{st}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention kernel: dtype {q.dtype} (takes "
                         "float32 or bfloat16)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {D} (takes "
                         f"{HEAD_DIMS})")
    kernel = route(q.dtype, D)
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    if B * Hq * Tq == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "sm90":
        plan = sm90_plan(q, k, v, out, head_axis)
        lib = _lib("flash_attention_sm90")
        geom = (ctypes.c_ulonglong * 32)(*(x for g in plan
                                           for x in g.packed()))
        rc = lib.flash_sm90_launch(
            D, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
            Hq, Hkv, Tq, Tk, geom, int(causal), float(sm_scale), stream)
        err = lib.flash_sm90_error_string
    else:
        lib = _lib("flash_attention")
        t_axis = 3 - head_axis
        bth = [(st[0], st[t_axis], st[head_axis])
               for st in (*strides, out.stride())]
        # cp.async stages k/v rows in 16-byte pieces
        es = q.element_size()
        aligned = (k.data_ptr() | v.data_ptr()) % 16 == 0 and all(
            x * es % 16 == 0 for x in bth[1] + bth[2])
        rc = lib.flash_attention_launch(
            _DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, Tq, Tk, *bth[0], *bth[1], *bth[2],
            *bth[3], int(causal), float(sm_scale), int(aligned), stream)
        err = lib.flash_attention_error_string
    if rc != 0:
        raise RuntimeError(f"flash attention {kernel} kernel launch failed: "
                           + err(rc).decode())
    if kernel == "sm90":
        sm90_launch_count += 1
    else:
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
