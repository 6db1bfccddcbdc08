"""Flash attention forward: CUDA kernel wrappers and their plain version.

Attention with an online softmax, causal (top-left: query row ``r`` sees
keys ``c <= r``) or full, optionally local (``window``: row ``r`` sees
only keys ``c > r - window``, on top of the causal mask, as
``repro/models/layers.py::flash_attention_xla`` masks), fp32 accumulation
and the output in the input dtype (fp32 or bf16).  Three entry points,
two kernel sources:

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
  (``wgmma``, TMA, ``mbarrier`` ring) for bf16 at D 64, 128 and 256
  (recurrentgemma-2b's head dim; 64-row kv tiles there).  TMA needs a
  16-byte aligned base and 16-byte multiples for every stride:
  :func:`sm90_plan` checks them and raises on anything else;
* ``"cuda_core"`` — ``csrc/flash_attention.cu`` for bf16 at D 16 and 32
  (on the tensor cores, ``mma.sync``) and fp32 at D 16-128 (on the CUDA
  cores: tensor-core TF32 would miss fp32's 2e-5), one block per 64-row
  q tile.

A case a kernel takes always goes to it: a failed build or launch raises
and never falls back to the other kernel or to the plain version.  On CPU
tensors each entry point runs :func:`attention_plain`, the same function
in plain PyTorch (ported from ``repro/kernels/ref.py::flash_attention``
with the top-left causal mask of the kernels).  That is the only place the
plain version stands in for a kernel.

``launch_count`` (the CUDA-core kernel), ``sm90_launch_count`` (the
sm90 kernel at D 64 and 128) and ``d256_launch_count`` (the sm90 kernel
at D 256) count kernel launches (never plain-version calls), so a run can
show which kernel served its main path.

Gradients.  The reference gets its attention gradient from ``jax.grad``
of ``flash_attention_xla``; the Pallas kernel has no backward.  Here the
entry points run through :class:`FlashAttentionFn` whenever grad is
enabled and an input requires it: its forward is the same kernel launch
(same route, same count), and its backward launches
``csrc/flash_attention_bwd.cu`` (bf16 at D 16-128, Tq == Tk; counted in
``bwd_launch_count``), or on CPU tensors runs
:func:`attention_backward_plain`.  A case the backward kernel does not
take (fp32, D 256) raises on the card: ROADMAP.md queue 2 item 2(c).
With grad disabled nothing is saved and the same launches happen.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims of the fp32 (CUDA-core) kernel; bf16 takes all of HEAD_DIMS
FP32_HEAD_DIMS = (16, 32, 64, 128)
#: the window the kernels are given for "no window": every row - col of a
#: launch is below it (the launchers take the window as a C int)
NO_WINDOW = 1 << 30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: what the tensor-core kernel takes: bf16 at these head dims
SM90_HEAD_DIMS = (64, 128, 256)
#: its q tile rows, kv tile rows by head dim, the rows of output one
#: consumer warpgroup stores (the TMA box heights), and the box width
SM90_BLOCK_Q = 128
SM90_BLOCK_K = {64: 128, 128: 128, 256: 64}
SM90_STORE_ROWS = 64
SM90_BOX_COLS = 64

#: "cuda_core" kernel launches since import (or the last reset by the
#: caller)
launch_count = 0
#: tensor-core (sm90) kernel launches at D 64 and 128, counted the same
#: way
sm90_launch_count = 0
#: its launches at D 256 (recurrentgemma-2b's), counted the same way
d256_launch_count = 0
#: backward kernel calls (``csrc/flash_attention_bwd.cu``: one call is
#: its dQ pass and its dK/dV pass), counted the same way
bwd_launch_count = 0
#: head dims of the backward kernel (bf16 only)
BWD_HEAD_DIMS = (16, 32, 64, 128)


def _visible(Tq: int, Tk: int, causal: bool, window, device):
    """The (Tq, Tk) bool mask of the kernels, or None when every pair is
    visible."""
    if not causal and window is None:
        return None
    rows = torch.arange(Tq, device=device)[:, None]
    cols = torch.arange(Tk, device=device)[None, :]
    vis = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        vis &= rows >= cols
    if window is not None:
        vis &= rows - cols < window
    return vis


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, sm_scale: float,
                    window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel in ``(B, H, T, D)`` layout:
    ``q (B, Hq, Tq, D)``, ``k, v (B, Hkv, Tk, D)``, ``Hq % Hkv == 0``.
    Scores in fp32 times ``sm_scale``, the top-left causal mask and the
    window mask ``(row - col) < window``, softmax, and the product with
    ``v`` in fp32, cast back to ``q.dtype``."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Tq, D)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float()) * sm_scale
    vis = _visible(Tq, Tk, causal, window, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return o.reshape(B, Hq, Tq, D).to(q.dtype)


def attention_backward_plain(q, k, v, o, do, *, causal: bool,
                             sm_scale: float, window: int | None = None,
                             head_axis: int = 1):
    """Plain PyTorch version of the backward kernel: ``(dq, dk, dv)`` of
    attention at ``q, k, v`` (the forward's output ``o``, its cotangent
    ``do``) in the layout ``head_axis`` gives (1: ``(B, H, T, D)``, 2:
    ``(B, T, H, D)``), each in its input's dtype.  All in fp32: P
    recomputed under the kernels' top-left causal mask and window,
    ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P * (dP - rowsum(dO * O))``,
    ``dQ = dS K * sm_scale``, ``dK = dS^T Q * sm_scale``; a kv head's dK
    and dV sum over the query heads that share it."""
    if head_axis == 2:
        t = lambda x: x.transpose(1, 2)
        dq, dk, dv = attention_backward_plain(
            t(q), t(k), t(v), t(o), t(do), causal=causal,
            sm_scale=sm_scale, window=window, head_axis=1)
        return t(dq), t(dk), t(dv)
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = lambda x: x.float().reshape(B, Hkv, Hq // Hkv, Tq, D)
    qf, of, dof = g(q), g(o), g(do)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf) * sm_scale
    vis = _visible(Tq, Tk, causal, window, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, float("-inf"))
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p, dof)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dof, vf)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, kf) * sm_scale
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds, qf) * sm_scale
    return (dq.reshape(B, Hq, Tq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves ``dtype`` at ``head_dim`` on the card:
    ``"sm90"`` for bf16 at D 64, 128 or 256, else ``"cuda_core"``.  The
    layout and the window do not enter: both layouts and strided views go
    to the same kernel (or raise, if TMA cannot take their alignment)."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    return "cuda_core"


def counter(dtype: torch.dtype, head_dim: int) -> str:
    """The launch count a call at ``dtype`` and ``head_dim`` adds one to:
    ``"cuda_core"`` (``launch_count``), ``"sm90"`` or, for the sm90
    kernel's D-256 launches, ``"d256"``."""
    kind = route(dtype, head_dim)
    return "d256" if kind == "sm90" and head_dim == 256 else kind


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
    with: q in boxes of ``SM90_BLOCK_Q`` rows, k and v of the head dim's
    ``SM90_BLOCK_K``, the output stored in boxes of ``SM90_STORE_ROWS``."""
    kv_rows = SM90_BLOCK_K.get(q.shape[3], SM90_BLOCK_K[64])
    return (tma_geometry(q, head_axis, SM90_BLOCK_Q, "q"),
            tma_geometry(k, head_axis, kv_rows, "k"),
            tma_geometry(v, head_axis, kv_rows, "v"),
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
                           + [ci, ci, ctypes.c_float, ci, vp])
        elif name == "flash_attention_bwd":
            fn = lib.flash_bwd_launch
            err = lib.flash_bwd_error_string
            fn.argtypes = ([ci] + [vp] * 10 + [ci] * 5
                           + [ctypes.POINTER(ll), ci, ci, ctypes.c_float,
                              vp])
        else:
            fn, err = lib.flash_sm90_launch, lib.flash_sm90_error_string
            fn.argtypes = ([ci, vp, vp, vp, vp] + [ci] * 5
                           + [ctypes.POINTER(ctypes.c_ulonglong), ci, ci,
                              ctypes.c_float, vp])
        fn.restype = ci
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def _check(q, k, v, head_axis: int, window: int | None = None):
    """Shapes ``(B, Hq, Tq, D)`` / ``(B, Hkv, Tk, D)`` with the head axis
    at ``head_axis`` (1 or 2) and a window of at least 1 (or None);
    returns ``(B, Hq, Hkv, Tq, Tk, D)``."""
    if window is not None and window < 1:
        raise ValueError(f"flash attention: window {window} (takes None or "
                         "a window of at least 1)")
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
                   head_axis: int, window: int | None = None) -> torch.Tensor:
    """Launch the kernel :func:`route` picks on the current stream (no
    synchronise).  ``head_axis`` 1: ``(B, H, T, D)`` tensors; 2: ``(B, T,
    H, D)``.  The output is contiguous in the same layout as ``q``."""
    global launch_count, sm90_launch_count, d256_launch_count
    B, Hq, Hkv, Tq, Tk, D = _check(q, k, v, head_axis, window)
    win = NO_WINDOW if window is None else min(int(window), NO_WINDOW)
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
    dims = HEAD_DIMS if q.dtype == torch.bfloat16 else FP32_HEAD_DIMS
    if D not in dims:
        raise ValueError(f"flash attention kernel: head_dim {D} in "
                         f"{q.dtype} (takes {dims})")
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
            Hq, Hkv, Tq, Tk, geom, int(causal), win, float(sm_scale),
            stream)
        err = lib.flash_sm90_error_string
    else:
        lib = _lib("flash_attention")
        t_axis = 3 - head_axis
        bth = [(st[0], st[t_axis], st[head_axis])
               for st in (*strides, out.stride())]
        # cp.async stages k/v rows in 16-byte pieces
        es = q.element_size()
        aligned = (k.data_ptr() | v.data_ptr()) % 16 == 0 \
            and all(x * es % 16 == 0 for x in bth[1] + bth[2])
        rc = lib.flash_attention_launch(
            _DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, Tq, Tk, *bth[0], *bth[1], *bth[2],
            *bth[3], int(causal), win, float(sm_scale), int(aligned), stream)
        err = lib.flash_attention_error_string
    if rc != 0:
        raise RuntimeError(f"flash attention {kernel} kernel launch failed: "
                           + err(rc).decode())
    name = counter(q.dtype, D)
    if name == "cuda_core":
        launch_count += 1
    elif name == "d256":
        d256_launch_count += 1
    else:
        sm90_launch_count += 1
    return out


def _rows_aligned(x) -> bool:
    """Every row of ``x`` (its last axis) starts on 16 bytes."""
    es = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        x.stride(a) * es % 16 == 0 for a in range(x.dim() - 1))


def attention_backward_cuda(q, k, v, o, do, *, causal: bool,
                            sm_scale: float, head_axis: int,
                            window: int | None = None):
    """Launch the backward kernel (``csrc/flash_attention_bwd.cu``) on
    the current stream: ``(dq, dk, dv)``, contiguous in the inputs'
    layout.  Takes bf16 at ``BWD_HEAD_DIMS`` with Tq == Tk, any strides
    with a contiguous head dim that start q's, k's, v's and dO's rows on
    16 bytes; raises ``NotImplementedError`` for fp32
    and D 256 (ROADMAP.md queue 2 item 2(c)) and ``ValueError`` for the
    rest it does not take.  One call, one count."""
    global bwd_launch_count
    B, Hq, Hkv, Tq, Tk, D = _check(q, k, v, head_axis, window)
    if q.dtype != torch.bfloat16 or D not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash attention backward on the card takes bf16 at head dim "
            f"{BWD_HEAD_DIMS}, got {q.dtype} at {D}: the fp32 and D-256 "
            "backward kernels are ROADMAP.md queue 2 item 2(c)")
    if Tq != Tk:
        raise ValueError(f"flash attention backward: Tq {Tq} != Tk {Tk} "
                         "(training has Tq == Tk)")
    dev = q.device
    ins = (q, k, v, o, do)
    for name, x in zip(("q", "k", "v", "o", "do"), ins):
        if x.device != dev or x.dtype != q.dtype or x.stride(3) != 1:
            raise ValueError(f"flash attention backward: {name} must be on "
                             f"{dev} in {q.dtype} with a contiguous last "
                             f"axis, got {x.dtype} on {x.device}, strides "
                             f"{x.stride()}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash attention backward: o {tuple(o.shape)} and "
                         f"do {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    # cp.async stages q, k, v and dO rows in 16-byte pieces
    for name, x in zip(("q", "k", "v", "do"), (q, k, v, do)):
        if not _rows_aligned(x):
            raise ValueError(f"flash attention backward: {name}'s rows must "
                             f"start on 16 bytes, got base {x.data_ptr()} "
                             f"and strides {x.stride()}")
    win = NO_WINDOW if window is None else min(int(window), NO_WINDOW)
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=dev)
                  for x in (q, k, v))
    if B * Hq * Tq == 0:
        return dq, dk.zero_(), dv.zero_()
    # the dQ pass leaves each row's log-sum-exp (base 2) and
    # rowsum(dO * O) here for the dK/dV pass
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse)
    t_axis = 3 - head_axis
    outs = (dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(
        s for x in ins + outs
        for s in (x.stride(0), x.stride(t_axis), x.stride(head_axis))))
    lib = _lib("flash_attention_bwd")
    rc = lib.flash_bwd_launch(
        D, *(x.data_ptr() for x in ins + outs), lse.data_ptr(),
        delta.data_ptr(), B, Hq, Hkv, Tq, Tk, strides, int(causal), win,
        float(sm_scale), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash attention backward kernel launch failed: "
                           + lib.flash_bwd_error_string(rc).decode())
    bwd_launch_count += 1
    return dq, dk, dv


def _forward(q, k, v, causal, sm_scale, head_axis, window):
    kind = q.device.type
    if kind == "cuda":
        return attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale,
                              head_axis=head_axis, window=window)
    if kind != "cpu":
        raise NotImplementedError(f"flash attention on {kind!r} tensors")
    _check(q, k, v, head_axis, window)
    if head_axis == 1:
        return attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               window=window)
    t = lambda x: x.transpose(1, 2)
    return t(attention_plain(t(q), t(k), t(v), causal=causal,
                             sm_scale=sm_scale, window=window))


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the forward is :func:`_forward`'s
    kernel launch (or plain version on CPU tensors) and saves q, k, v and
    its output; the backward launches the backward kernel on CUDA tensors
    (:func:`attention_backward_cuda`) and runs
    :func:`attention_backward_plain` on CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, head_axis, window):
        o = _forward(q, k, v, causal, sm_scale, head_axis, window)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = dict(causal=causal, sm_scale=sm_scale,
                        head_axis=head_axis, window=window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        if q.device.type == "cuda":
            if do.stride(3) != 1 or not _rows_aligned(do):
                do = do.contiguous()
            grads = attention_backward_cuda(q, k, v, o, do, **ctx.args)
        else:
            grads = attention_backward_plain(q, k, v, o, do, **ctx.args)
        return (*grads, None, None, None, None)


def _attend(q, k, v, causal, sm_scale, head_axis, window):
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, sm_scale, head_axis,
                                      window)
    return _forward(q, k, v, causal, sm_scale, head_axis, window)


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """``q, k, v: (B, H, T, D)`` with equal head counts -> ``(B, H, Tq,
    D)``.  ``sm_scale`` defaults to ``1/sqrt(D)``; ``window`` (None: no
    window) masks keys ``c <= r - window`` of query row ``r``."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"flash_attention takes equal head counts, got "
                         f"{q.shape[1]} and {k.shape[1]}; use "
                         "gqa_flash_attention")
    return _attend(q, k, v, causal, sm_scale, 1, window)


def gqa_flash_attention(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None,
                        window: int | None = None) -> torch.Tensor:
    """``q: (B, Hq, T, D)``; ``k, v: (B, Hkv, T, D)`` with
    ``Hq % Hkv == 0``; kv heads are shared, not repeated."""
    return _attend(q, k, v, causal, sm_scale, 1, window)


def flash_attention_bthd(q, k, v, *, causal: bool = True,
                         sm_scale: float | None = None,
                         window: int | None = None) -> torch.Tensor:
    """The model's layout: ``q: (B, Tq, Hq, D)``; ``k, v: (B, Tk, Hkv,
    D)`` -> ``(B, Tq, Hq, D)``."""
    return _attend(q, k, v, causal, sm_scale, 2, window)
