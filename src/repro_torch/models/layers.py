"""Core NN layers: params-as-data, RMSNorm, RoPE, flash attention, decode
attention, SwiGLU — the port of ``repro/models/layers.py``.

Layout conventions (as the JAX package):
  activations  (B, T, D)
  attention    (B, T, H, Dh)
  weights      declared via :class:`ParamDef` and held by a
               :class:`ParamTree` module (``p["wq"]`` reads like the JAX
               package's dicts)

Prefill attention goes through the hand-written CUDA kernel of
``repro_torch.kernels.flash_attention`` (its plain version on CPU
tensors), where the JAX model calls the XLA ``flash_attention_xla``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import flash_attention as FA

PARAM_DTYPE = torch.bfloat16
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    logical_axes: tuple
    init: str = "normal"        # normal | zeros
    fan_in_dims: tuple = (-2,)  # dims whose product scales normal init


class ParamTree(nn.Module):
    """The parameters of a ParamDef tree: leaves are ``nn.Parameter``s
    (inference only: no gradient), dicts are child trees and lists are
    ``nn.ModuleList``s of trees.  ``p["wq"]`` and ``"mlp" in p`` read as
    they do on the JAX package's dicts.  Built uninitialised (on
    ``device="meta"`` nothing is allocated); see :func:`init_tree`."""

    def __init__(self, defs: dict, device=None):
        super().__init__()
        for name, d in sorted(defs.items()):
            if isinstance(d, dict):
                self.add_module(name, ParamTree(d, device))
            elif isinstance(d, list):
                self.add_module(name, nn.ModuleList(
                    ParamTree(x, device) for x in d))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(d.shape, dtype=PARAM_DTYPE, device=device),
                    requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def init_param(gen: torch.Generator, d: ParamDef, out: torch.Tensor):
    """Fill ``out`` as the JAX package's ``init_param`` draws (zeros, or a
    unit normal in fp32 times ``1/sqrt(prod(shape[fan_in]))``, cast to
    bf16), from the torch generator ``gen``: the same rule, not the same
    numbers."""
    with torch.no_grad():
        if d.init == "zeros":
            out.zero_()
        else:
            fan_in = int(np.prod([d.shape[i] for i in d.fan_in_dims])) or 1
            z = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=out.device)
            out.copy_(z.mul_(1.0 / math.sqrt(fan_in)))


def init_tree(gen: torch.Generator, defs: dict, device) -> ParamTree:
    """A :class:`ParamTree` of ``defs`` on ``device``, every leaf drawn
    from ``gen`` in sorted path order (as the JAX package splits its key
    over the sorted leaves)."""
    tree = ParamTree(defs, device)
    for path, d in sorted(_flatten(defs)):
        node = tree
        for p in path:
            node = node[p]
        init_param(gen, d, node)
    return tree


def _flatten(defs, prefix=()):
    items = enumerate(defs) if isinstance(defs, list) else defs.items()
    for k, v in items:
        key = prefix + (k if isinstance(defs, dict) else int(k),)
        if isinstance(v, (dict, list)):
            yield from _flatten(v, key)
        else:
            yield (key, v)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float, device=None):
    """fp32 ``theta ** -(i / half)``; made on ``device`` (a tensor made on
    the host and copied would block the host on every call)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (B, T, H, D); positions: (B, T) int.  fp32 inside, cast back."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(x.shape[-1], theta, x.device)        # (half,)
    ang = positions[..., None].float() * freqs               # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """Prefill attention in the model's layout: q (B, Tq, H, Dh); k, v
    (B, Tk, Hkv, Dh) with GQA read in place -> (B, Tq, H, Dh) in q's
    dtype.  Takes ``flash_attention_xla``'s place; the scale is
    ``1/sqrt(Dh)``."""
    if window is not None:
        raise NotImplementedError(
            "local attention (window) is not ported yet: ROADMAP.md queue 1 "
            "item 13")
    return FA.flash_attention_bthd(q, k, v, causal=causal,
                                   sm_scale=1.0 / math.sqrt(q.shape[-1]))


def decode_attention(q, k_cache, v_cache, cache_len: int):
    """Single-token attention against a cache, in plain PyTorch (the JAX
    package computes it outside any kernel too).

    q: (B, 1, H, Dh); k_cache/v_cache: (B, S, Hkv, Dh); entries at
    positions >= cache_len are masked with -1e30."""
    B, _, H, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    scale = 1.0 / np.sqrt(Dh)
    qf = q.reshape(B, Hkv, rep, Dh).float() * scale
    s = torch.einsum("bgrd,bsgd->bgrs", qf, k_cache.float())
    mask = torch.arange(S, device=q.device) < cache_len
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def ffn_defs(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("embed_tp", "ffn")),
        "w_up": ParamDef((d_model, d_ff), ("embed_tp", "ffn")),
        "w_down": ParamDef((d_ff, d_model), ("ffn", "embed_tp")),
    }


def ffn_apply(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
