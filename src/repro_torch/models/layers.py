"""Core NN layers: params-as-data, RMSNorm, RoPE/M-RoPE, flash attention,
decode attention, SwiGLU — the port of ``repro/models/layers.py``.

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
from torch import nn

from repro_torch.kernels import flash_attention as FA
from repro_torch.sharding.rules import (is_dtensor, local_attention,
                                        shard_reshape)

PARAM_DTYPE = torch.bfloat16
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    logical_axes: tuple
    init: str = "normal"        # normal | zeros | ones
    fan_in_dims: tuple = (-2,)  # dims whose product scales normal init


class ParamTree(nn.Module):
    """The parameters of a ParamDef tree: leaves are ``nn.Parameter``s,
    dicts are child trees and lists are ``nn.ModuleList``s of trees.
    ``p["wq"]`` and ``"mlp" in p`` read as they do on the JAX package's
    dicts.  Built uninitialised (on ``device="meta"`` nothing is
    allocated); see :func:`init_tree`.  Leaves are made with
    ``requires_grad=False``, so serving builds no autograd graph;
    training switches them on with ``tree.requires_grad_(True)``
    (``repro_torch.train.train_init`` does)."""

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

    def replaced(self, leaves: dict, prefix: str = "") -> "ParamTree":
        """A tree of the same structure whose leaves are ``leaves[name]``
        (names as ``named_parameters()`` gives them), held as they are (no
        copy), each with this tree's ``requires_grad``: the functional
        update of a training step."""
        new = ParamTree({})
        for name, p in self._parameters.items():
            new.register_parameter(name, nn.Parameter(
                leaves[prefix + name], requires_grad=p.requires_grad))
        for name, m in self._modules.items():
            if isinstance(m, nn.ModuleList):
                new.add_module(name, nn.ModuleList(
                    c.replaced(leaves, f"{prefix}{name}.{i}.")
                    for i, c in enumerate(m)))
            else:
                new.add_module(name, m.replaced(leaves,
                                                f"{prefix}{name}."))
        return new


def init_param(gen: torch.Generator, d: ParamDef, out: torch.Tensor):
    """Fill ``out`` as the JAX package's ``init_param`` draws (zeros, ones,
    or a unit normal in fp32 times ``1/sqrt(prod(shape[fan_in]))``, cast
    to bf16), from the torch generator ``gen``: the same rule, not the
    same numbers."""
    with torch.no_grad():
        if d.init == "zeros":
            out.zero_()
        elif d.init == "ones":
            out.fill_(1.0)
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


def apply_mrope(x, positions3, theta: float = 10_000.0,
                sections=(16, 24, 24)):
    """Qwen2-VL multimodal RoPE.  positions3: (B, T, 3) = (t, h, w) ids.
    The half-dim rotary channels are partitioned into ``sections`` (scaled
    to ``half``, the rounding left to the last), each rotated by its own
    position stream."""
    half = x.shape[-1] // 2
    sec = [s * half // sum(sections) for s in sections]
    sec[-1] += half - sum(sec)                    # absorb rounding
    freqs = _rope_freqs(x.shape[-1], theta, x.device)        # (half,)
    # choose the position stream per frequency channel: channel c reads
    # stream i where sum(sec[:i]) <= c < sum(sec[:i + 1]) (made on the
    # device: no host-to-device copy)
    c = torch.arange(half, device=x.device)
    stream = sum((c >= sum(sec[:i])).long() for i in range(1, len(sec)))
    ang = positions3[..., stream].float() * freqs            # (B, T, half)
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
    dtype.  Takes ``flash_attention_xla``'s place (``window``: query row
    ``r`` sees keys ``c`` with ``r - c < window``); the scale is
    ``1/sqrt(Dh)``.  DTensor inputs go through
    :func:`repro_torch.sharding.rules.local_attention`."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    attend = lambda q, k, v: FA.flash_attention_bthd(
        q, k, v, causal=causal, window=window, sm_scale=scale)
    if is_dtensor(q):
        return local_attention(attend, q, k, v)
    return attend(q, k, v)


def decode_attention(q, k_cache, v_cache, cache_len: int, *,
                     window: Optional[int] = None):
    """Single-token attention against a cache, in plain PyTorch (the JAX
    package computes it outside any kernel too).

    q: (B, 1, H, Dh); k_cache/v_cache: (B, S, Hkv, Dh); entries at
    positions >= cache_len are masked with -1e30.  For local attention
    the cache is a ring buffer of ``window`` slots and is fully attended,
    so ``window`` masks nothing here (as in the JAX package)."""
    B, _, H, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    scale = 1.0 / np.sqrt(Dh)
    qf = shard_reshape(q, B, Hkv, rep, Dh).float() * scale
    s = torch.einsum("bgrd,bsgd->bgrs", qf, k_cache.float())
    mask = torch.arange(S, device=q.device) < cache_len
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v_cache.float())
    return shard_reshape(out, B, 1, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def ffn_defs(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("embed_tp", "ffn")),
        "w_up": ParamDef((d_model, d_ff), ("embed_tp", "ffn")),
        "w_down": ParamDef((d_ff, d_model), ("ffn", "embed_tp")),
    }


def silu(x):
    """``jax.nn.silu`` op for op: ``x * (1 / (1 + exp(-x)))``, each op
    rounded to ``x``'s dtype as the reference's graph rounds it (``F.silu``
    rounds a bf16 result once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def ffn_apply(p, x):
    h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
