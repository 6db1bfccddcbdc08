"""Residual blocks — the port of ``repro/models/blocks.py``, attention
family only (global GQA attention with its bf16 KV cache).  Each block
kind provides

    <kind>_defs(cfg)                          -> ParamDef tree
    <kind>_apply(cfg, p, x, ctx)              -> x'           (prefill)
    <kind>_decode(cfg, p, x, state, ctx)      -> (x', state') (one token)
    <kind>_init_state(cfg, batch, cache_len)  -> state

The other kinds (local attention, MoE, RG-LRU, mLSTM, sLSTM), qk-norm,
M-RoPE and the int8 KV cache raise ``NotImplementedError`` naming
ROADMAP.md (queue 1 item 13); so the ``local`` flag of the JAX package's
attention functions is not here.

Decode writes the cache **in place** (slice assignment into the state's
tensors) where the JAX package builds a new array with
``dynamic_update_slice``; the returned state is the same object.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import (ParamDef, apply_rope,
                                       decode_attention, ffn_apply,
                                       ffn_defs, rmsnorm)

_TODO = "is not ported yet: ROADMAP.md queue 1 item 13"


class Ctx(NamedTuple):
    positions: torch.Tensor           # (B, T)
    cache_index: int                  # write position for decode
    cache_len: int                    # valid cache length (after write)


def _unsupported(cfg):
    if cfg.qk_norm:
        raise NotImplementedError(f"qk_norm (qwen3, glm4) {_TODO}")
    if cfg.rope not in ("rope", "none"):
        raise NotImplementedError(f"rope={cfg.rope!r} {_TODO}")
    if cfg.kv_quant:
        raise NotImplementedError(f"the int8 KV cache (kv_quant) {_TODO}")


# ===========================================================================
# Attention (global), GQA
# ===========================================================================

def attn_defs(cfg) -> dict:
    _unsupported(cfg)
    d, dq, dkv = cfg.d_model, cfg.d_qkv, cfg.d_kv
    defs = {
        "norm": ParamDef((d,), (None,), init="zeros"),
        "wq": ParamDef((d, dq), ("embed_tp", "qkv")),
        "wk": ParamDef((d, dkv), ("embed_tp", "kv_heads")),
        "wv": ParamDef((d, dkv), ("embed_tp", "kv_heads")),
        "wo": ParamDef((dq, d), ("qkv", "embed_tp")),
    }
    ff = cfg.d_ff_dense or cfg.d_ff
    if ff:
        defs["mlp"] = ffn_defs(d, ff)
        defs["mlp_norm"] = ParamDef((d,), (None,), init="zeros")
    return defs


def _qkv(cfg, p, x, ctx):
    _unsupported(cfg)
    B, T, _ = x.shape
    q = (x @ p["wq"]).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    if cfg.rope == "rope":
        q = apply_rope(q, ctx.positions, cfg.rope_theta)
        k = apply_rope(k, ctx.positions, cfg.rope_theta)
    return q, k, v


def _attn_core(cfg, p, x, ctx):
    q, k, v = _qkv(cfg, p, x, ctx)
    o = L.flash_attention(q, k, v, causal=True)
    B, T = x.shape[:2]
    return o.reshape(B, T, cfg.d_qkv) @ p["wo"]


def _block(cfg, p, x, mixer_out):
    x = x + mixer_out
    if "mlp" in p:
        x = x + ffn_apply(p["mlp"], rmsnorm(x, p["mlp_norm"], cfg.norm_eps))
    return x


def attn_apply(cfg, p, x, ctx):
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    return _block(cfg, p, x, _attn_core(cfg, p, h, ctx))


class AttnState(NamedTuple):
    k: torch.Tensor    # (B, S, Hkv, Dh) bf16
    v: torch.Tensor


def attn_init_state(cfg, batch: int, cache_len: int, device=None):
    _unsupported(cfg)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return AttnState(k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
                     v=torch.zeros(shape, dtype=torch.bfloat16, device=device))


def _cache_update_attend(cfg, q, k, v, state, ctx):
    """Write this step's k/v at ``ctx.cache_index`` (in place) and attend
    over the first ``min(cache_len, S)`` entries."""
    _unsupported(cfg)
    S = state.k.shape[1]
    slot = min(max(ctx.cache_index, 0), S - k.shape[1])  # as the JAX clamp
    state.k[:, slot:slot + k.shape[1]] = k.to(state.k.dtype)
    state.v[:, slot:slot + v.shape[1]] = v.to(state.v.dtype)
    clen = min(ctx.cache_len, S)
    o = decode_attention(q, state.k, state.v, clen)
    return o, state


def attn_decode(cfg, p, x, state, ctx):
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h, ctx)
    o, state = _cache_update_attend(cfg, q, k, v, state, ctx)
    B = x.shape[0]
    out = o.reshape(B, 1, cfg.d_qkv) @ p["wo"]
    return _block(cfg, p, x, out), state


# ===========================================================================
# Block registry
# ===========================================================================

def _kind(kind: str):
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} {_TODO}")


def block_defs(cfg, kind: str) -> dict:
    _kind(kind)
    return attn_defs(cfg)


def block_apply(cfg, kind: str, p, x, ctx):
    """-> (x', aux_loss, None): attention has no state to return here
    (the model recomputes its cache, as the JAX package does)."""
    _kind(kind)
    return attn_apply(cfg, p, x, ctx), torch.zeros((), device=x.device), None


def block_init_state(cfg, kind: str, batch: int, cache_len: int,
                     device=None):
    _kind(kind)
    return attn_init_state(cfg, batch, cache_len, device=device)


def block_decode(cfg, kind: str, p, x, state, ctx):
    _kind(kind)
    return attn_decode(cfg, p, x, state, ctx)
