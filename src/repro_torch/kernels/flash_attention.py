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
(same route, same count) that also writes each row's log-sum-exp (lse,
base 2 of the scaled scores, fp32 ``(B, Hq, Tq)``), and its backward
reads that lse and launches, by :func:`route` again,

* ``"sm90"`` — ``csrc/flash_attention_bwd_sm90.cu`` for bf16 at D 64, 128
  and 256 (``wgmma``, TMA ring; counted in ``bwd_sm90_launch_count``),
  under the same TMA alignment rules (:func:`sm90_bwd_plan`);
* ``"cuda_core"`` — ``csrc/flash_attention_bwd.cu`` for bf16 at D 16/32
  (``mma.sync``) and fp32 at D 16-128 (CUDA cores; counted in
  ``bwd_launch_count``): ONE launch whose grid holds dQ blocks and dK/dV
  blocks side by side (:func:`bwd_core_plan`, :func:`bwd_core_block`:
  heaviest tiles first), each block computing rowsum(dO * O) for the q
  rows it touches, so no block waits on another.  bf16 is bound by
  latency at the reduced models' shapes (microseconds of work at either
  roof): 32-row own tiles put 128 blocks on the card there, four warps
  split each tile step, every operand comes by ``cp.async`` and
  ``ldmatrix``, mask-free steps skip the masks.  fp32 is bound by the FMA
  rate and the shared-memory reads feeding it: register-tiled outer
  products (a 4 x 4 micro-tile of S and dP a thread, 8 x 4 at D 64,
  16-byte vector operands, P and dS through shared memory once);

both with Tq == Tk.  On CPU tensors it runs :func:`attention_backward_plain`
with the same lse.  With grad disabled no lse is written, nothing is saved
and the same launches happen.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims of the fp32 (CUDA-core) kernel; bf16 takes all of HEAD_DIMS
FP32_HEAD_DIMS = (16, 32, 64, 128)
#: the window the kernels are given for "no window": every row - col of a
#: launch is below it (the launchers take the window as a C int)
NO_WINDOW = 1 << 30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: log2(e): the kernels keep scores, the softmax and lse in base 2
LOG2E = 1.4426950408889634
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
#: CUDA-core backward kernel calls (``csrc/flash_attention_bwd.cu``: one
#: call is its dQ pass and its dK/dV pass), counted the same way
bwd_launch_count = 0
#: tensor-core backward kernel calls (``csrc/flash_attention_bwd_sm90.cu``:
#: one call is its prep, dQ, dK/dV and, with a head split, reduce
#: launches), counted the same way
bwd_sm90_launch_count = 0
#: the CUDA-core backward's own tile by dtype and head dim: the q rows (dQ
#: role) or kv rows (dK/dV role) one block of its single launch owns
BWD_CORE_ROWS = {(torch.bfloat16, 16): 32, (torch.bfloat16, 32): 32,
                 (torch.float32, 16): 64, (torch.float32, 32): 64,
                 (torch.float32, 64): 128, (torch.float32, 128): 64}
#: the sm90 backward's tiles: its dK/dV kernel's q tiles (the TMA plan's
#: box rows), its kv tiles by head dim, and its lse / delta rows padded to
#: a multiple
BWD_SM90_ROWS = 64
BWD_SM90_KV_ROWS = {64: 128, 128: 128, 256: 64}
BWD_SM90_PAD = 128


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
                    causal: bool, sm_scale: float, window: int | None = None,
                    return_lse: bool = False):
    """Plain PyTorch version of the kernel in ``(B, H, T, D)`` layout:
    ``q (B, Hq, Tq, D)``, ``k, v (B, Hkv, Tk, D)``, ``Hq % Hkv == 0``.
    Scores in fp32 times ``sm_scale``, the top-left causal mask and the
    window mask ``(row - col) < window``, softmax, and the product with
    ``v`` in fp32, cast back to ``q.dtype``.  With ``return_lse`` also the
    rows' log-sum-exp in the kernels' units, base 2 of the scaled scores
    (``logsumexp(s * sm_scale) * log2 e``), fp32 ``(B, Hq, Tq)``: ``(out,
    lse)``."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Tq, D)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float()) * sm_scale
    vis = _visible(Tq, Tk, causal, window, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    o = o.reshape(B, Hq, Tq, D).to(q.dtype)
    if not return_lse:
        return o
    return o, (torch.logsumexp(s, dim=-1) * LOG2E).reshape(B, Hq, Tq)


def attention_backward_plain(q, k, v, o, do, lse=None, *, causal: bool,
                             sm_scale: float, window: int | None = None,
                             head_axis: int = 1):
    """Plain PyTorch version of the backward kernels: ``(dq, dk, dv)`` of
    attention at ``q, k, v`` (the forward's output ``o``, its cotangent
    ``do``, and optionally its ``lse``) in the layout ``head_axis`` gives
    (1: ``(B, H, T, D)``, 2: ``(B, T, H, D)``), each in its input's dtype.
    All in fp32: P recomputed under the kernels' top-left causal mask and
    window, as the softmax of the scores or, given the forward's lse
    (``(B, Hq, Tq)``, base 2 of the scaled scores, as the kernels read it),
    as ``exp2(S * sm_scale * log2 e - lse)``; ``dV = P^T dO``, ``dP = dO
    V^T``, ``dS = P * (dP - rowsum(dO * O))``, ``dQ = dS K * sm_scale``,
    ``dK = dS^T Q * sm_scale``; a kv head's dK and dV sum over the query
    heads that share it."""
    if head_axis == 2:
        t = lambda x: x.transpose(1, 2)
        dq, dk, dv = attention_backward_plain(
            t(q), t(k), t(v), t(o), t(do), lse, causal=causal,
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
    if lse is None:
        p = torch.softmax(s, dim=-1)
    else:
        p = torch.exp2(s * LOG2E - lse.float().reshape(B, Hkv, Hq // Hkv, Tq,
                                                       1))
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


def sm90_bwd_plan(q, k, v, do, head_axis: int):
    """The TMA geometries ``(q, k, v, dO)`` of the sm90 backward (its
    launcher picks each kernel's box rows: q and dO 128 for the dQ kernel
    and 64 for the dK/dV kernel, k and v each kernel's kv tile).  Raises
    ``ValueError`` as :func:`tma_geometry` does."""
    return tuple(tma_geometry(x, head_axis, BWD_SM90_ROWS, name)
                 for x, name in zip((q, k, v, do), ("q", "k", "v", "do")))


def bwd_head_split(B: int, Hkv: int, T: int, D: int, rep: int,
                   n_sm: int) -> int:
    """Into how many groups the sm90 backward's dK/dV kernel splits each kv
    head's ``rep`` query heads: 1 when its (kv tile of
    ``BWD_SM90_KV_ROWS[D]`` rows, kv head, batch) work tiles fill the
    card's ``n_sm`` SMs, else the nearest whole multiple of them, at most
    ``rep`` (MQA at recurrentgemma-2b's training shape, (1, 4096, 10, 1,
    256): 64 tiles, split 2).  A split makes fp32 partial dK and dV that a
    last pass sums in split order."""
    tiles = -(-T // BWD_SM90_KV_ROWS[D]) * Hkv * B
    if tiles >= n_sm:
        return 1
    return max(1, min(rep, round(n_sm / tiles)))


def bwd_core_plan(dtype: torch.dtype, D: int, B: int, T: int, Hq: int,
                  Hkv: int) -> tuple:
    """The CUDA-core backward's launch: ``(rows, n_blocks)``, its own-tile
    rows for ``dtype`` at head dim ``D`` (``BWD_CORE_ROWS``) and one block
    per (own tile, head, batch) of each role: ``ceil(T / rows) * B * (Hq +
    Hkv)``."""
    rows = BWD_CORE_ROWS[dtype, D]
    return rows, -(-T // rows) * B * (Hq + Hkv)


def bwd_core_block(i: int, B: int, T: int, Hq: int, Hkv: int, rows: int,
                   causal: bool) -> tuple:
    """Block ``i``'s work in the CUDA-core backward, as its kernel decodes
    it: ``(role, tile, head, batch)`` with role ``"dkdv"`` (kv tile, kv
    head) or ``"dq"`` (q tile, q head).  Blocks come in levels of ``B *
    (Hq + Hkv)``, a level's dK/dV blocks first; level 0 holds the tiles
    that see the most: under the causal mask the bottom q tile and the top
    kv tile, with only a window (or neither) the top q tile and the bottom
    kv tile."""
    n_tiles = -(-T // rows)
    level, r = divmod(i, B * (Hq + Hkv))
    dq = r >= B * Hkv
    if dq:
        r -= B * Hkv
    H = Hq if dq else Hkv
    tile = level if bool(causal) != dq else n_tiles - 1 - level
    return ("dq" if dq else "dkdv"), tile, r % H, r // H


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
            fn.argtypes = ([ci, ci] + [vp] * 5 + [ci] * 5 + [ll] * 12
                           + [ci, ci, ctypes.c_float, ci, vp])
        elif name == "flash_attention_bwd":
            fn = lib.flash_bwd_launch
            err = lib.flash_bwd_error_string
            fn.argtypes = ([ci, ci] + [vp] * 9 + [ci] * 5
                           + [ctypes.POINTER(ll), ci, ci, ctypes.c_float,
                              ci, ci, vp])
        elif name == "flash_attention_bwd_sm90":
            fn = lib.flash_bwd_sm90_launch
            err = lib.flash_bwd_sm90_error_string
            fn.argtypes = ([ci] + [vp] * 12 + [ci] * 5
                           + [ctypes.POINTER(ctypes.c_ulonglong),
                              ctypes.POINTER(ll), ci, ci, ctypes.c_float,
                              vp])
        else:
            fn, err = lib.flash_sm90_launch, lib.flash_sm90_error_string
            fn.argtypes = ([ci] + [vp] * 5 + [ci] * 5
                           + [ctypes.POINTER(ctypes.c_ulonglong), ci, ci,
                              ctypes.c_float, vp])
        fn.restype = ci
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def _n_sm(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
                   head_axis: int, window: int | None = None,
                   return_lse: bool = False):
    """Launch the kernel :func:`route` picks on the current stream (no
    synchronise).  ``head_axis`` 1: ``(B, H, T, D)`` tensors; 2: ``(B, T,
    H, D)``.  The output is contiguous in the same layout as ``q``.  With
    ``return_lse`` the kernel also writes the rows' log-sum-exp (fp32
    ``(B, Hq, Tq)``, base 2 of the scaled scores): ``(out, lse)``."""
    global launch_count, sm90_launch_count, d256_launch_count
    B, Hq, Hkv, Tq, Tk, D = _check(q, k, v, head_axis, window)
    win = NO_WINDOW if window is None else min(int(window), NO_WINDOW)
    dev = q.device
    strides = [t.stride() for t in (q, k, v)]
    for name, t in zip("qkv", (q, k, v)):
        if t.device != dev or t.dtype != q.dtype or t.stride(3) != 1:
            raise ValueError(f"flash attention kernel: {name} must be on "
                             f"{dev} in {q.dtype} with a contiguous last "
                             f"axis, got {t.dtype} on {t.device}, strides "
                             f"{t.stride()}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention kernel: dtype {q.dtype} (takes "
                         "float32 or bfloat16)")
    dims = HEAD_DIMS if q.dtype == torch.bfloat16 else FP32_HEAD_DIMS
    if q.shape[3] not in dims:
        raise ValueError(f"flash attention kernel: head_dim {D} in "
                         f"{q.dtype} (takes {dims})")
    kernel = route(q.dtype, D)
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=dev) \
        if return_lse else None
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    lse_ptr = None if lse is None else lse.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "sm90":
        plan = sm90_plan(q, k, v, out, head_axis)
        lib = _lib("flash_attention_sm90")
        geom = (ctypes.c_ulonglong * 32)(*(x for g in plan
                                           for x in g.packed()))
        rc = lib.flash_sm90_launch(
            D, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_ptr, B, Hq, Hkv, Tq, Tk, geom, int(causal), win,
            float(sm_scale), stream)
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
            out.data_ptr(), lse_ptr, B, Hq, Hkv, Tq, Tk, *bth[0], *bth[1],
            *bth[2],
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
    return (out, lse) if return_lse else out


def _rows_aligned(x) -> bool:
    """Every row of ``x`` (its last axis) starts on 16 bytes."""
    es = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        x.stride(a) * es % 16 == 0 for a in range(x.dim() - 1))


def attention_backward_cuda(q, k, v, o, do, lse, *, causal: bool,
                            sm_scale: float, head_axis: int,
                            window: int | None = None):
    """Launch the backward kernel :func:`route` picks on the current
    stream: ``(dq, dk, dv)``, contiguous in the inputs' layout.  ``lse`` is
    the forward's (``attention_cuda(..., return_lse=True)``).  Takes the
    forward's dtypes and head dims (bf16 at 16-256, fp32 at 16-128) with
    Tq == Tk: bf16 at D 64/128/256 on the sm90 kernel (any strides TMA can
    read, :func:`sm90_bwd_plan`, and o's rows on 16 bytes), the rest on the
    CUDA-core kernel (rows of q, k, v, o and dO on 16 bytes: ``cp.async``;
    one launch of :func:`bwd_core_plan`'s blocks).
    Raises ``ValueError`` for what neither takes.  One call, one count on
    its kernel's counter."""
    global bwd_launch_count, bwd_sm90_launch_count
    B, Hq, Hkv, Tq, Tk, D = _check(q, k, v, head_axis, window)
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention backward: dtype {q.dtype} (takes "
                         "float32 or bfloat16)")
    dims = HEAD_DIMS if q.dtype == torch.bfloat16 else FP32_HEAD_DIMS
    if D not in dims:
        raise ValueError(f"flash attention backward: head_dim {D} in "
                         f"{q.dtype} (takes {dims}, as the forward)")
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
    if lse.shape != (B, Hq, Tq) or lse.dtype != torch.float32 \
            or lse.device != dev or not lse.is_contiguous():
        raise ValueError(f"flash attention backward: lse must be the "
                         f"forward's contiguous fp32 (B, Hq, Tq) = "
                         f"{(B, Hq, Tq)} on {dev}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    kernel = route(q.dtype, D)
    if kernel == "sm90":
        plan = sm90_bwd_plan(q, k, v, do, head_axis)
    # cp.async stages q, k, v, o and dO rows in 16-byte pieces; the sm90
    # kernel's prep pass reads o's rows in 16-byte pieces
    for name, x in (zip(("o",), (o,)) if kernel == "sm90" else
                    zip(("q", "k", "v", "o", "do"), ins)):
        if not _rows_aligned(x):
            raise ValueError(f"flash attention backward: {name}'s rows "
                             f"must start on 16 bytes, got base "
                             f"{x.data_ptr()} and strides {x.stride()}")
    win = NO_WINDOW if window is None else min(int(window), NO_WINDOW)
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=dev)
                  for x in (q, k, v))
    if B * Hq * Tq == 0:
        return dq, dk.zero_(), dv.zero_()
    t_axis = 3 - head_axis
    bth = lambda xs: (ctypes.c_longlong * (3 * len(xs)))(*(
        s for x in xs for s in (x.stride(0), x.stride(t_axis),
                                x.stride(head_axis))))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "sm90":
        split = bwd_head_split(B, Hkv, Tq, D, Hq // Hkv, _n_sm(dev))
        t_pad = -(-Tq // BWD_SM90_PAD) * BWD_SM90_PAD
        # the forward's lse and rowsum(dO * O), padded per (batch, head)
        lse_pad, delta = (torch.empty((B, Hq, t_pad), dtype=torch.float32,
                                      device=dev) for _ in range(2))
        part = torch.empty((split, 2, B, Hkv, Tq, D), dtype=torch.float32,
                           device=dev) if split > 1 else None
        geom = (ctypes.c_ulonglong * 32)(*(x for g in plan
                                           for x in g.packed()))
        lib = _lib("flash_attention_bwd_sm90")
        rc = lib.flash_bwd_sm90_launch(
            D, *(x.data_ptr() for x in ins + (dq, dk, dv, lse, lse_pad,
                                             delta)),
            None if part is None else part.data_ptr(), split, B, Hq, Hkv,
            Tq, geom, bth((o, do, dq, dk, dv)), int(causal), win,
            float(sm_scale), stream)
        err = lib.flash_bwd_sm90_error_string
    else:
        rows, n_blocks = bwd_core_plan(q.dtype, D, B, Tq, Hq, Hkv)
        lib = _lib("flash_attention_bwd")
        rc = lib.flash_bwd_launch(
            _DTYPES[q.dtype], D, *(x.data_ptr() for x in ins + (dq, dk, dv)),
            lse.data_ptr(), B, Hq, Hkv, Tq, Tk, bth(ins + (dq, dk, dv)),
            int(causal), win, float(sm_scale), rows, n_blocks, stream)
        err = lib.flash_bwd_error_string
    if rc != 0:
        raise RuntimeError(f"flash attention backward {kernel} kernel launch "
                           "failed: " + err(rc).decode())
    if kernel == "sm90":
        bwd_sm90_launch_count += 1
    else:
        bwd_launch_count += 1
    return dq, dk, dv


def _forward(q, k, v, causal: bool, sm_scale: float, head_axis: int,
             window: int | None, return_lse: bool = False):
    kind = q.device.type
    if kind == "cuda":
        return attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale,
                              head_axis=head_axis, window=window,
                              return_lse=return_lse)
    if kind != "cpu":
        raise NotImplementedError(f"flash attention on {kind!r} tensors")
    _check(q, k, v, head_axis, window)
    if head_axis == 1:
        return attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               window=window, return_lse=return_lse)
    t = lambda x: x.transpose(1, 2)
    res = attention_plain(t(q), t(k), t(v), causal=causal,
                          sm_scale=sm_scale, window=window,
                          return_lse=return_lse)
    return (t(res[0]), res[1]) if return_lse else t(res)


# ---------------------------------------------------------------------------
# The entry points as operators: fake tensors, DTensor and the flop counter
# ---------------------------------------------------------------------------
#
# The kernels are ctypes launches, which no fake tensor, DTensor or flop
# counter can see through.  So the forward (without and with the lse) and
# the backward are ``torch.library`` custom operators: on real tensors each
# runs exactly the launch above (same route, same counter, no fallback; a
# failed build or launch raises), or the plain version on CPU tensors.
# Each also has a fake implementation (shapes only) and a flop formula
# that counts the visible (row, col) pairs the kernels visit (causal,
# windowed), not Tq * Tk.  DTensor inputs reach them through the model's
# ``local_map`` (``repro_torch.sharding.rules.local_attention``), which
# keeps batch and head shards local.
#
# An operator call costs tens of microseconds of dispatch on the host,
# as much as a small kernel's whole launch.  The entry points therefore
# call the same bodies directly when nothing could intercept the
# operator (:func:`_direct`: plain tensors and no dispatch mode on the
# stack), and go through the operators otherwise (fake tensors, DTensor
# shards under a mode, the flop counter, ``CommDebugMode``).

@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  head_axis: int, causal: bool, window: Optional[int],
                  sm_scale: float) -> torch.Tensor:
    return _forward(q, k, v, causal, sm_scale, head_axis, window)


@torch.library.custom_op("repro_torch::flash_fwd_lse", mutates_args=())
def _flash_fwd_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      head_axis: int, causal: bool, window: Optional[int],
                      sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    o, lse = _forward(q, k, v, causal, sm_scale, head_axis, window,
                      return_lse=True)
    return o, lse


def _backward(q, k, v, o, do, lse, head_axis: int, causal: bool,
              window: int | None, sm_scale: float):
    args = dict(causal=causal, sm_scale=sm_scale, head_axis=head_axis,
                window=window)
    if q.device.type == "cuda":
        if do.stride(3) != 1 or not _rows_aligned(do):
            do = do.contiguous()
        return attention_backward_cuda(q, k, v, o, do, lse, **args)
    return attention_backward_plain(q, k, v, o, do, lse, **args)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                  head_axis: int, causal: bool, window: Optional[int],
                  sm_scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _backward(q, k, v, o, do, lse, head_axis, causal, window,
                     sm_scale)


def _direct(*ts) -> bool:
    """Whether a call on ``ts`` may skip the operators: every tensor a
    plain ``torch.Tensor`` (no fake tensor, no DTensor) and no dispatch
    mode on the stack (no ``FakeTensorMode``, flop counter or
    ``CommDebugMode``).  The operators run the same bodies."""
    return all(type(t) is torch.Tensor for t in ts) \
        and torch._C._len_torch_dispatch_stack() == 0


def _lse_shape(q, head_axis: int):
    return (q.shape[0], q.shape[head_axis], q.shape[3 - head_axis])


@_flash_fwd_op.register_fake
def _(q, k, v, head_axis, causal, window, sm_scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@_flash_fwd_lse_op.register_fake
def _(q, k, v, head_axis, causal, window, sm_scale):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(_lse_shape(q, head_axis), dtype=torch.float32))


@_flash_bwd_op.register_fake
def _(q, k, v, o, do, lse, head_axis, causal, window, sm_scale):
    return tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                 for x in (q, k, v))


def visible_pairs(Tq: int, Tk: int, causal: bool, window) -> int:
    """The (query row, key col) pairs the kernels' masks leave visible
    (:func:`_visible`): row ``r`` sees cols ``c`` with ``c <= r`` when
    causal (top-left) and ``r - c < window`` with a window."""
    if not causal:
        if window is None:
            return Tq * Tk
        return sum(Tk - min(Tk, max(0, r - window + 1)) for r in range(Tq))
    m = Tk if window is None else min(int(window), Tk)
    # row r sees min(r + 1, m) cols
    if Tq <= m:
        return Tq * (Tq + 1) // 2
    return m * (m + 1) // 2 + (Tq - m) * m


def attention_flops(q_shape, k_shape, head_axis: int, causal: bool,
                    window, backward: bool = False) -> int:
    """Multiply-adds x 2 of the visible pairs: the forward's ``S = Q K^T``
    and ``O = P V`` (4 D a pair), the backward's recomputed ``S``, ``dV``,
    ``dP``, ``dQ`` and ``dK`` (10 D a pair)."""
    B, Hq, Tq, D = (q_shape[0], q_shape[head_axis], q_shape[3 - head_axis],
                    q_shape[3])
    Tk = k_shape[3 - head_axis]
    return (10 if backward else 4) * B * Hq * D * visible_pairs(
        Tq, Tk, causal, window)


def _register_counters():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula([torch.ops.repro_torch.flash_fwd,
                            torch.ops.repro_torch.flash_fwd_lse])
    def _fwd_flops(q, k, v, head_axis, causal, window, sm_scale, *a,
                   **kw) -> int:
        return attention_flops(q, k, head_axis, causal, window)

    @register_flop_formula(torch.ops.repro_torch.flash_bwd)
    def _bwd_flops(q, k, v, o, do, lse, head_axis, causal, window,
                   sm_scale, *a, **kw) -> int:
        return attention_flops(q, k, head_axis, causal, window,
                               backward=True)


_register_counters()


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the forward is the
    ``flash_fwd_lse`` operator (:func:`_forward`'s kernel launch, or the
    plain version on CPU tensors), which also writes the rows' lse, and
    saves q, k, v, its output and the lse; the backward is the
    ``flash_bwd`` operator, which launches a backward kernel on CUDA
    tensors (:func:`attention_backward_cuda`) and runs
    :func:`attention_backward_plain` on CPU ones, both reading that lse.
    Each calls its operator's body directly where :func:`_direct` allows."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, head_axis, window):
        if _direct(q, k, v):
            o, lse = _forward(q, k, v, causal, sm_scale, head_axis, window,
                              return_lse=True)
        else:
            o, lse = torch.ops.repro_torch.flash_fwd_lse(
                q, k, v, head_axis, causal, window, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (head_axis, causal, window, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        op = _backward if _direct(q, k, v, o, do, lse) \
            else torch.ops.repro_torch.flash_bwd
        grads = op(q, k, v, o, do, lse, *ctx.args)
        return (*grads, None, None, None, None)


def _attend(q, k, v, causal: bool, sm_scale: float | None, head_axis: int,
            window: int | None):
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sm_scale = float(sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, sm_scale, head_axis,
                                      window)
    if _direct(q, k, v):
        return _forward(q, k, v, causal, sm_scale, head_axis, window)
    return torch.ops.repro_torch.flash_fwd(q, k, v, head_axis, causal,
                                           window, sm_scale)


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
