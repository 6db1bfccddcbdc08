"""The LM loss head on the tensor cores: the negative log-likelihood of a
chunk of rows against a bf16 head, with its gradient.

``loss_head(x, w, labels)`` takes ``x`` (R, D) bf16, the head ``w`` (D,
V) bf16 (a tied head's ``embed.T`` as it is: the products read the
transpose from its strides) and ``labels`` (R,) (-1: no loss) and returns
each row's nll, fp32 (R,), 0 where the label is -1; the audio stub's
codebooks, ``w`` (K, D, V) with labels (R, K), give an nll (R, K), one
codebook after the other.  It runs :class:`LossHeadFn`:

* forward — ``logits = x @ w`` as one bf16 x bf16 product with fp32
  accumulation and fp32 output (:func:`head_mm`), then the ``xent_fwd``
  kernel reads the logits once and writes each row's lse and nll.  Only
  ``x``, ``w`` (the parameter itself, no copy), the labels and the lse are
  saved: no fp32 weight and no logits;
* backward — the logits again with the same product, then the
  ``xent_bwd`` kernel writes the logits' gradient ``d`` (fp32) exactly as
  three bf16 terms stacked ``(3R, V)``, ``[hi; mid; lo]``, and two more
  products: ``dX = sum of the three (R, D) blocks of [hi; mid; lo] @ w^T``
  and ``dW = [x; x; x]^T @ [hi; mid; lo]``, each reducing in fp32 and
  written in fp32, then cast to the operand's bf16 (as autograd casts the
  gradient of ``.float()``: one contribution a chunk).

Every partial product of the three products is a product of two bf16
values, exact in fp32, summed in fp32: the reference's ``x.float() @
w.float()`` and its gradient (``src/repro/models/model.py::_xent``) in
another order of the fp32 sums.  Neither TF32 (which applies to fp32
operands) nor a bf16 rounding of ``d``: ``hi + mid + lo == d`` for every
``d`` from 2^-110 up (``csrc/loss_head.cu`` says why and below).

:func:`head_mm` on CUDA tensors is ``torch.mm(a, b,
out_dtype=torch.float32)`` (``aten::mm.dtype``): cuBLAS with bf16 operands,
fp32 compute type and an fp32 output.  Its reduction stays fp32
throughout: ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_
reduction`` lets cuBLAS reduce split-K partial sums in a bf16 *output's*
type, and this output is fp32, so the setting does not apply (on the card
the same product gives the same bits with the setting on and off:
``tests/test_torch_loss_head_cuda.py``).  On CPU tensors it is ``a.float()
@ b.float()``: the same exact products, fp32 sums.

The two kernels (``csrc/loss_head.cu``, built for ``sm_90a`` at first
use) run on CUDA tensors; on CPU tensors :func:`xent_fwd` and
:func:`xent_bwd` run :func:`xent_fwd_plain` and :func:`xent_bwd_plain`,
the same arithmetic in plain PyTorch.  ``fwd_launch_count`` and
``bwd_launch_count`` count kernel launches (never plain calls).

The head takes bf16 tensors on one device; ``models.model._bf16_head``
chooses it, and keeps the fp32 einsum for the rest: fp32 operands (the
exact split needs bf16 ones) and DTensors (a vocab-sharded head's
logsumexp crosses shards).
"""
from __future__ import annotations

import ctypes

import torch

#: ``xent_fwd`` / ``xent_bwd`` kernel launches since import (or the last
#: reset by the caller)
fwd_launch_count = 0
bwd_launch_count = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load("loss_head")
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.xent_fwd_launch.argtypes = [vp, vp, ci, vp, vp, ci, ci, vp]
        lib.xent_bwd_launch.argtypes = [vp, vp, vp, ci, vp, ll, vp, ci, ci,
                                        vp]
        lib.xent_fwd_launch.restype = lib.xent_bwd_launch.restype = ci
        lib.loss_head_error_string.argtypes = [ci]
        lib.loss_head_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def head_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 matrices in fp32: exact products, fp32 sums and
    output (cuBLAS on the card, ``aten::mm.dtype``)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _check(lg, labels, *rows):
    """Logits ``(R, V)`` contiguous fp32, labels ``(R,)`` int32 or int64,
    and any ``rows`` (lse, g) fp32 ``(R,)``, all on the logits' device."""
    if lg.dim() != 2 or lg.dtype != torch.float32 or \
            not lg.is_contiguous() or lg.shape[1] >= 2 ** 31:
        raise ValueError(f"loss head: logits {tuple(lg.shape)} "
                         f"{lg.dtype}: want contiguous fp32 (R, V)")
    if labels.shape != lg.shape[:1] or labels.dtype not in (
            torch.int32, torch.int64):
        raise ValueError(f"loss head: labels {tuple(labels.shape)} "
                         f"{labels.dtype}: want int32 or int64 "
                         f"({lg.shape[0]},)")
    for t in rows:
        if t.shape != lg.shape[:1] or t.dtype != torch.float32:
            raise ValueError(f"loss head: {tuple(t.shape)} {t.dtype}: want "
                             f"fp32 ({lg.shape[0]},)")
    if any(t.device != lg.device for t in (labels, *rows)):
        raise ValueError(f"loss head: every operand on {lg.device}")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"loss head {what} kernel launch failed: "
                           + _lib().loss_head_error_string(rc).decode())


def xent_fwd_plain(lg, labels):
    """``(lse, nll)`` of fp32 logits ``(R, V)``: logsumexp, and lse minus
    the label's logit where the label is not negative, else 0."""
    lse = torch.logsumexp(lg, dim=-1)
    mask = labels >= 0
    true_lg = torch.gather(lg, -1, labels.clamp_min(0).long()[:, None])
    return lse, torch.where(mask, lse - true_lg[:, 0], torch.zeros_like(lse))


def xent_fwd(lg, labels):
    """``(lse, nll)``, fp32 ``(R,)`` each: the ``xent_fwd`` kernel on CUDA
    tensors, :func:`xent_fwd_plain` on CPU ones."""
    global fwd_launch_count
    labels = labels.contiguous()
    _check(lg, labels)
    if not lg.is_cuda:
        return xent_fwd_plain(lg, labels)
    R, V = lg.shape
    lse = torch.empty(R, dtype=torch.float32, device=lg.device)
    nll = torch.empty_like(lse)
    if R == 0:
        return lse, nll
    stream = torch.cuda.current_stream(lg.device).cuda_stream
    _raise_on(_lib().xent_fwd_launch(
        lg.data_ptr(), labels.data_ptr(), labels.element_size(),
        lse.data_ptr(), nll.data_ptr(), R, V, stream), "xent_fwd")
    fwd_launch_count += 1
    return lse, nll


def split3(d: torch.Tensor) -> torch.Tensor:
    """fp32 ``d`` as three bf16 terms stacked on dim 0, ``[hi; mid; lo]``:
    ``hi = bf16(d)``, ``mid = bf16(d - hi)``, ``lo = bf16(d - hi - mid)``
    (both differences exact), so ``hi + mid + lo == d`` for ``|d|`` from
    2^-110 to bf16's largest finite value, and 0."""
    hi = d.bfloat16()
    r = d - hi.float()
    mid = r.bfloat16()
    return torch.cat([hi, mid, (r - mid.float()).bfloat16()])


def xent_bwd_plain(lg, lse, labels, g):
    """The gradient of :func:`xent_fwd_plain`'s nll at the logits, for the
    nll's gradient ``g`` (R,), as :func:`split3`'s three bf16 terms
    ``(3R, V)``; autograd's arithmetic: ``g exp(lg - lse)``, the label's
    ``g`` subtracted after, rows with a negative label 0."""
    mask = labels >= 0
    gm = torch.where(mask, g.float(), torch.zeros_like(lse))[:, None]
    d = gm * (lg - lse[:, None]).exp()
    d.scatter_add_(1, labels.clamp_min(0).long()[:, None], -gm)
    return split3(d)


def xent_bwd(lg, lse, labels, g):
    """:func:`xent_bwd_plain`'s ``(3R, V)`` bf16 terms: the ``xent_bwd``
    kernel on CUDA tensors (``g`` read through its stride, so an expanded
    gradient is not copied), the plain version on CPU ones."""
    global bwd_launch_count
    labels, lse = labels.contiguous(), lse.contiguous()
    _check(lg, labels, lse, g)
    if not lg.is_cuda:
        return xent_bwd_plain(lg, lse, labels, g)
    R, V = lg.shape
    out = torch.empty((3 * R, V), dtype=torch.bfloat16, device=lg.device)
    if R == 0:
        return out
    stream = torch.cuda.current_stream(lg.device).cuda_stream
    _raise_on(_lib().xent_bwd_launch(
        lg.data_ptr(), lse.data_ptr(), labels.data_ptr(),
        labels.element_size(), g.data_ptr(), g.stride(0), out.data_ptr(),
        R, V, stream), "xent_bwd")
    bwd_launch_count += 1
    return out


def head_grads(x, w, labels, lse, g, need_x: bool = True,
               need_w: bool = True):
    """fp32 ``(dX, dW)`` of the nll at ``x`` (R, D) and ``w`` (D, V) (None
    where not needed): the logits again, :func:`xent_bwd`'s three terms,
    and the two products over them.  ``dW`` comes out in ``w``'s layout: a
    transposed ``w`` (a tied head's ``embed.T``) gets the transpose of a
    row-major ``(V, D)`` product."""
    d3 = xent_bwd(head_mm(x, w), lse, labels, g)
    dx = dw = None
    if need_x:
        dx = head_mm(d3, w.t()).view(3, *x.shape).sum(0)
    if need_w:
        x3 = torch.cat([x, x, x])
        dw = head_mm(x3.t(), d3) if w.stride(-1) == 1 \
            else head_mm(d3.t(), x3).t()
    return dx, dw


class LossHeadFn(torch.autograd.Function):
    """``(x, w, labels) -> nll`` (module notes): ``w`` (D, V) with labels
    and nll (R,), or the audio stub's codebooks, ``w`` (K, D, V) with
    labels and nll (R, K), one codebook's products and kernels after the
    other and dX summed over them in fp32 before its one cast.  Saves
    ``x``, ``w``, the labels and each codebook's lse; the backward
    recomputes the logits."""

    @staticmethod
    def forward(ctx, x, w, labels):
        out = [xent_fwd(head_mm(x, wk), lk)
               for wk, lk in zip(_codebooks(w), _codebooks(labels, 1))]
        ctx.save_for_backward(x, w, labels, *(lse for lse, _ in out))
        nll = [n for _, n in out]
        return nll[0] if w.dim() == 2 else torch.stack(nll, 1)

    @staticmethod
    def backward(ctx, g):
        x, w, labels, *lses = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        dx, dws = None, []
        for wk, lk, lse, gk in zip(_codebooks(w), _codebooks(labels, 1),
                                   lses, _codebooks(g, 1)):
            a, b = head_grads(x, wk, lk, lse, gk, need_x, need_w)
            dx = a if dx is None else dx + a
            dws.append(b)
        dw = None
        if need_w:
            dw = (dws[0] if w.dim() == 2 else torch.stack(dws)).to(w.dtype)
        return None if dx is None else dx.to(x.dtype), dw, None


def _codebooks(t, dim: int = 0) -> list:
    """``t`` as the list of its codebooks along ``dim``: itself when it has
    none (a 2-d head, 1-d labels or gradient)."""
    if t.dim() == (2 if dim == 0 else 1):
        return [t]
    return [t.select(dim, k) for k in range(t.shape[dim])]


def loss_head(x, w, labels):
    """Each row's nll, fp32, of ``x`` (R, D) against ``w`` (D, V) for
    ``labels`` (R,), or against the codebooks ``w`` (K, D, V) for
    ``labels`` (R, K) (an nll (R, K)); bf16 operands; label -1: no loss,
    nll 0."""
    if not (x.dtype == w.dtype == torch.bfloat16 and x.device == w.device):
        raise ValueError(f"loss head: x {x.dtype} on {x.device}, w "
                         f"{w.dtype} on {w.device}: takes bf16 tensors on "
                         "one device")
    return LossHeadFn.apply(x, w, labels)
