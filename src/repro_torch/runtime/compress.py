"""int8 gradient compression with error feedback, the port of
``repro/runtime/compress.py``.

Each gradient tensor is quantised to int8 with one fp32 scale (max |x| /
127; ``torch.round`` rounds half to even, as ``jnp.round``), and the
quantisation error is carried to the next step as a residual, so the
accumulated compressed gradients track the true ones.  The reference
shapes it for a data-parallel all-reduce and never wires it into its
train step; neither does the port (its hook signature ``(grads,
residual) -> (grads, residual)`` differs from ``make_train_step``'s
``grad_transform``).  Gradient trees are nested dicts of tensors.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def make_int8_compressor():
    """Returns (transform, init_residual).  transform is stateful via an
    explicit residual tree: (grads, residual) -> (grads', residual')."""

    def init_residual(params):
        return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)

    def transform(grads, residual):
        def one(g, r):
            gf = g.float() + r
            q, s = quantize_int8(gf)
            deq = dequantize_int8(q, s)
            return deq.to(g.dtype), gf - deq
        out = _tree_map(one, grads, residual)
        first = lambda t, i: {k: first(v, i) for k, v in t.items()} \
            if isinstance(t, dict) else t[i]
        return first(out, 0), first(out, 1)

    return transform, init_residual
