"""Residual blocks — the port of ``repro/models/blocks.py``: attention
(global or local-window, with optional qk-norm and GQA) with its bf16 KV
cache, and the RG-LRU block of recurrentgemma.  Each block kind provides

    <kind>_defs(cfg)                          -> ParamDef tree
    <kind>_apply(cfg, p, x, ctx)              -> x'           (prefill)
    <kind>_decode(cfg, p, x, state, ctx)      -> (x', state') (one token)
    <kind>_init_state(cfg, batch, cache_len)  -> state

The other kinds (MoE, mLSTM, sLSTM), M-RoPE and the int8 KV cache raise
``NotImplementedError`` naming ROADMAP.md (queue 1 item 13).

Decode writes the attention cache **in place** (slice assignment into the
state's tensors) where the JAX package builds a new array with
``dynamic_update_slice``; the returned state is the same object.  A local
attention layer's cache is a ring of ``min(attn_window, cache_len)``
slots.

Where bf16 rounds.  The JAX package runs its repeated layer groups inside
one compiled ``lax.scan`` body and its remainder layers op by op.  Op by
op, every bf16 op rounds.  Compiled, XLA fuses each residual add into the
RMSNorm that reads it and keeps the sum in fp32 there (the residual
stream itself is rounded), within a layer and from one layer of a group
to the next; the scan's carry between groups is rounded.  In the RG-LRU
block it also feeds the conv's last tap sum to the gate unrounded.  A
random-weight model amplifies such one-ulp differences layer by layer
(the reduced recurrentgemma's logits move by 0.1-0.4 between the JAX
package's own two modes), so the port rounds where the reference does:
:func:`block_apply` and :func:`block_decode` take ``fused`` (a layer of
a scanned group) and hand the fp32 sum on (``resid``), and elementwise
chains (GELU, SiLU) round op by op.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

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
    if cfg.rope not in ("rope", "none"):
        raise NotImplementedError(f"rope={cfg.rope!r} {_TODO}")
    if cfg.kv_quant:
        raise NotImplementedError(f"the int8 KV cache (kv_quant) {_TODO}")


# ===========================================================================
# Attention (global or local-window), with optional qk-norm and GQA
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
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((cfg.head_dim,), (None,), init="zeros")
        defs["k_norm"] = ParamDef((cfg.head_dim,), (None,), init="zeros")
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
    if cfg.qk_norm:                 # per head, before RoPE
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope == "rope":
        q = apply_rope(q, ctx.positions, cfg.rope_theta)
        k = apply_rope(k, ctx.positions, cfg.rope_theta)
    return q, k, v


def _norm_in(cfg, p, x, resid):
    """The block's input RMSNorm, of the previous block's fp32 residual sum
    ``resid`` where it hands one over, else of ``x``; rounded to ``x``'s
    dtype."""
    return rmsnorm(x if resid is None else resid, p["norm"],
                   cfg.norm_eps).to(x.dtype)


def _attn_core(cfg, p, x, ctx, local: bool):
    q, k, v = _qkv(cfg, p, x, ctx)
    window = cfg.attn_window if local else None
    o = L.flash_attention(q, k, v, causal=True, window=window)
    B, T = x.shape[:2]
    return o.reshape(B, T, cfg.d_qkv) @ p["wo"]


def _block(cfg, p, x, mixer_out, fused: bool = False):
    """The residual adds and the MLP: -> ``(x', resid)``.  Unfused every
    add rounds and ``resid`` is None; fused (see the module notes) the MLP
    norm reads the first add's fp32 sum and ``resid`` is the second's, for
    the next block's norm.  ``x'`` is the same either way: a bf16 add
    rounds its fp32 sum."""
    if not fused:
        x = x + mixer_out
        if "mlp" in p:
            x = x + ffn_apply(p["mlp"], rmsnorm(x, p["mlp_norm"],
                                                cfg.norm_eps))
        return x, None
    s = x.float() + mixer_out.float()
    x = s.to(x.dtype)
    if "mlp" in p:
        h = rmsnorm(s, p["mlp_norm"], cfg.norm_eps).to(x.dtype)
        s = x.float() + ffn_apply(p["mlp"], h).float()
        x = s.to(x.dtype)
    return x, s


def _attn(cfg, p, x, ctx, local, resid=None, fused=False):
    h = _norm_in(cfg, p, x, resid)
    return _block(cfg, p, x, _attn_core(cfg, p, h, ctx, local), fused)


def attn_apply(cfg, p, x, ctx, local: bool = False):
    return _attn(cfg, p, x, ctx, local)[0]


class AttnState(NamedTuple):
    k: torch.Tensor    # (B, S, Hkv, Dh) bf16; a ring of S slots if local
    v: torch.Tensor


def attn_init_state(cfg, batch: int, cache_len: int, local: bool = False,
                    device=None):
    """A zero bf16 cache of ``S`` slots: ``min(attn_window, cache_len)``
    for a local layer (a ring), else ``cache_len``."""
    _unsupported(cfg)
    S = min(cfg.attn_window, cache_len) if (local and cfg.attn_window) \
        else cache_len
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return AttnState(k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
                     v=torch.zeros(shape, dtype=torch.bfloat16, device=device))


def _cache_update_attend(cfg, q, k, v, state, ctx, local: bool):
    """Write this step's k/v at ``ctx.cache_index`` (``% S`` in a local
    ring; in place) and attend over the first ``min(cache_len, S)``
    entries."""
    _unsupported(cfg)
    S = state.k.shape[1]
    slot = ctx.cache_index % S if local else ctx.cache_index
    slot = min(max(slot, 0), S - k.shape[1])   # as the JAX clamp
    state.k[:, slot:slot + k.shape[1]] = k.to(state.k.dtype)
    state.v[:, slot:slot + v.shape[1]] = v.to(state.v.dtype)
    clen = min(ctx.cache_len, S)
    o = decode_attention(q, state.k, state.v, clen,
                         window=cfg.attn_window if local else None)
    return o, state


def _attn_decode(cfg, p, x, state, ctx, local, resid=None, fused=False):
    h = _norm_in(cfg, p, x, resid)
    q, k, v = _qkv(cfg, p, h, ctx)
    o, state = _cache_update_attend(cfg, q, k, v, state, ctx, local)
    B = x.shape[0]
    out = o.reshape(B, 1, cfg.d_qkv) @ p["wo"]
    x, resid = _block(cfg, p, x, out, fused)
    return x, state, resid


def attn_decode(cfg, p, x, state, ctx, local: bool = False):
    return _attn_decode(cfg, p, x, state, ctx, local)[:2]


# ===========================================================================
# RG-LRU (recurrentgemma): conv1d(4) + gated linear recurrence
# ===========================================================================
#
# The JAX package runs the recurrence with ``jax.lax.associative_scan``
# (XLA, no Pallas kernel), so the port runs it in plain PyTorch: a
# log-depth scan in fp32.

def rglru_defs(cfg) -> dict:
    d = cfg.d_model
    defs = {
        "norm": ParamDef((d,), (None,), init="zeros"),
        "w_in": ParamDef((d, 2 * d), ("embed_tp", "ffn")),   # [branch, gate]
        "conv_w": ParamDef((4, d), (None, None)),
        "a_log": ParamDef((d,), (None,), init="ones"),
        "w_gate_a": ParamDef((d, d), ("embed_tp", "ffn")),
        "w_gate_x": ParamDef((d, d), ("embed_tp", "ffn")),
        "w_out": ParamDef((d, d), ("ffn", "embed_tp")),
    }
    if cfg.d_ff:
        defs["mlp"] = ffn_defs(d, cfg.d_ff)
        defs["mlp_norm"] = ParamDef((d,), (None,), init="zeros")
    return defs


def _causal_conv4(x, w, carry=None, fp32_last: bool = False):
    """Depthwise causal conv, window 4, in ``x``'s dtype (``w`` is cast to
    it and the four taps summed in order, as the JAX package does).  x:
    (B, T, D), w: (4, D), carry: (B, 3, D) previous inputs for decode
    continuity.  -> (out, the last 3 rows of the padded input).  With
    ``fp32_last`` the last of the three sums stays fp32 (the compiled
    reference's gate reads it so)."""
    if carry is None:
        pad = torch.zeros((x.shape[0], 3, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = carry.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, T+3, D)
    T = x.shape[1]
    taps = [xp[:, i:i + T] * w[i].to(x.dtype) for i in range(4)]
    head = (taps[0] + taps[1]) + taps[2]
    out = head.float() + taps[3].float() if fp32_last else head + taps[3]
    return out, xp[:, -3:]


def _softplus(x):
    """``jax.nn.softplus``: ``log(1 + exp(x))`` as ``logaddexp(x, 0)``
    everywhere (``F.softplus`` switches to ``x`` above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _const(v: float, dtype) -> float:
    """``v`` rounded to ``dtype`` (the reference's graph holds its
    constants in the operands' dtype)."""
    return float(torch.tensor(v, dtype=dtype))


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation, op for op:
    ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x*x*x))))`` with
    the constants and every op rounded to ``x``'s dtype, as the
    reference's graph computes it (``F.gelu`` rounds once)."""
    dt = x.dtype
    inner = x + _const(0.044715, dt) * (x * x * x)
    th = torch.tanh(_const(math.sqrt(2.0 / math.pi), dt) * inner)
    return x * (_const(0.5, dt) * (1.0 + th))


def _rglru_coeffs(cfg, p, u):
    """Per-step gates in fp32: a (decay in (0,1)) and the gated input,
    both (B, T, D).  ``u`` is the conv output in bf16, or in fp32 from a
    fused layer: the gate projections read it rounded, the gated input
    as given."""
    c = 8.0
    ub = u.to(p["w_gate_a"].dtype)
    r = torch.sigmoid((ub @ p["w_gate_a"]).float())
    i = torch.sigmoid((ub @ p["w_gate_x"]).float())
    log_a = -c * r * _softplus(p["a_log"].float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    gated = beta * i * u.float()
    return a, gated


def linear_scan(a, u):
    """``h_t = a_t h_{t-1} + u_t`` from ``h_{-1} = 0`` along axis 1: the
    inclusive scan of the combine ``(a1, u1), (a2, u2) -> (a1 a2,
    u1 a2 + u2)``, by Hillis-Steele doubling (``ceil(log2 T)`` rounds of
    elementwise ops: 12 at T 4096).  -> every ``h_t``, in ``u``'s dtype."""
    T, s = a.shape[1], 1
    while s < T:
        u = torch.cat([u[:, :s], torch.addcmul(u[:, s:], u[:, :-s],
                                               a[:, s:])], dim=1)
        if 2 * s < T:                 # the last round needs no products
            a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1)
        s *= 2
    return u


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, D) recurrent state (fp32)
    conv: torch.Tensor    # (B, 3, D) bf16


def _rglru(cfg, p, x, ctx, with_state, resid=None, fused=False):
    h = _norm_in(cfg, p, x, resid)
    uw = h @ p["w_in"]
    branch, u_pre = uw.chunk(2, dim=-1)
    u, _ = _causal_conv4(u_pre, p["conv_w"], fp32_last=fused)
    a, gated = _rglru_coeffs(cfg, p, u)
    hs = linear_scan(a, gated)
    y = hs.to(x.dtype) * _gelu(branch)
    xo, resid = _block(cfg, p, x, y @ p["w_out"], fused)
    if not with_state:
        return xo, None, resid
    T = x.shape[1]
    conv = F.pad(u_pre, (0, 0, max(3 - T, 0), 0))[:, -3:]
    return (xo, RGLRUState(h=hs[:, -1], conv=conv.to(torch.bfloat16)),
            resid)


def rglru_apply(cfg, p, x, ctx, with_state: bool = False):
    return _rglru(cfg, p, x, ctx, with_state)[:2]


def rglru_init_state(cfg, batch: int, cache_len: int, device=None):
    d = cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, d), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, 3, d), dtype=torch.bfloat16, device=device))


def _rglru_decode(cfg, p, x, state, ctx, resid=None, fused=False):
    h = _norm_in(cfg, p, x, resid)
    uw = h @ p["w_in"]
    branch, u = uw.chunk(2, dim=-1)
    u, conv = _causal_conv4(u, p["conv_w"], carry=state.conv,
                            fp32_last=fused)
    a, gated = _rglru_coeffs(cfg, p, u)
    hnew = a[:, 0] * state.h + gated[:, 0]           # (B, D)
    y = hnew[:, None, :].to(x.dtype) * _gelu(branch)
    x, resid = _block(cfg, p, x, y @ p["w_out"], fused)
    return x, RGLRUState(h=hnew, conv=conv), resid


def rglru_decode(cfg, p, x, state: RGLRUState, ctx):
    return _rglru_decode(cfg, p, x, state, ctx)[:2]


# ===========================================================================
# Block registry
# ===========================================================================

def _kind(kind: str):
    if kind in ("moe", "mlstm", "slstm"):
        raise NotImplementedError(f"block kind {kind!r} {_TODO}")
    if kind not in ("attn", "local_attn", "rglru"):
        raise KeyError(kind)


def block_defs(cfg, kind: str) -> dict:
    _kind(kind)
    return rglru_defs(cfg) if kind == "rglru" else attn_defs(cfg)


def block_apply(cfg, kind: str, p, x, ctx, with_state: bool = False, *,
                resid=None, fused: bool = False):
    """-> (x', aux_loss, state or None, resid'): attention returns no
    state here (the model recomputes its cache, as the JAX package does);
    RG-LRU returns its ``(h, conv)`` when ``with_state``.  ``fused`` and
    ``resid``/``resid'`` (the fp32 residual sum handed to the next block
    of a group, None unfused): see the module notes."""
    _kind(kind)
    zero = torch.zeros((), device=x.device)
    if kind == "rglru":
        xo, st, resid = _rglru(cfg, p, x, ctx, with_state, resid, fused)
        return xo, zero, st, resid
    xo, resid = _attn(cfg, p, x, ctx, kind == "local_attn", resid, fused)
    return xo, zero, None, resid


def block_init_state(cfg, kind: str, batch: int, cache_len: int,
                     device=None):
    _kind(kind)
    if kind == "rglru":
        return rglru_init_state(cfg, batch, cache_len, device=device)
    return attn_init_state(cfg, batch, cache_len,
                           local=kind == "local_attn", device=device)


def block_decode(cfg, kind: str, p, x, state, ctx, *, resid=None,
                 fused: bool = False):
    """-> (x', state', resid'), ``fused`` and ``resid`` as in
    :func:`block_apply`."""
    _kind(kind)
    if kind == "rglru":
        return _rglru_decode(cfg, p, x, state, ctx, resid, fused)
    return _attn_decode(cfg, p, x, state, ctx, kind == "local_attn", resid,
                        fused)
