"""Residual blocks — the port of ``repro/models/blocks.py``: attention
(global or local-window, with optional qk-norm, GQA and M-RoPE) with its
bf16 or int8 KV cache, MoE (GShard grouped or flat sort-based dispatch),
the RG-LRU block of recurrentgemma, and xLSTM's mLSTM and sLSTM.  Each
block kind provides

    <kind>_defs(cfg)                          -> ParamDef tree
    <kind>_apply(cfg, p, x, ctx)              -> x'           (prefill)
    <kind>_decode(cfg, p, x, state, ctx)      -> (x', state') (one token)
    <kind>_init_state(cfg, batch, cache_len)  -> state

Decode writes the attention cache **in place** (slice assignment into the
state's tensors) where the JAX package builds a new array with
``dynamic_update_slice``; the returned state is the same object.  A local
attention layer's cache is a ring of ``min(attn_window, cache_len)``
slots.  The int8 cache (``cfg.kv_quant``) holds per-(position, head)
fp32 scales beside its codes and is dequantised to bf16 for each decode
step, as the JAX package does.

The JAX package computes MoE dispatch and the expert MLPs with einsums,
and the xLSTM recurrences with ``lax.scan``, all outside any Pallas
kernel, so the port computes them in plain PyTorch: the expert products
are ``torch.einsum``, and the mLSTM/sLSTM prefill is a loop over T (the
max-stabiliser ``m`` makes the step non-associative, so RG-LRU's
log-depth scan does not apply).  Three of the reference's behaviours are
kept on purpose: ``jax.lax.top_k`` breaks ties to the lower index
(:func:`top_k`); the grouped dispatch's one-hot of a position past
capacity is a zero row; and the flat dispatch's scatter lets the last of
several writes to one slot win, which drops a kept token of expert
``E - 1`` when that expert overflows (:func:`moe_ffn`).

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
chains (GELU, SiLU) round op by op.  The moe block's attention add and
the MoE norm that reads it follow the same pattern as the MLP's, and so
do the xLSTM blocks' adds and the next block's norm.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import (ParamDef, apply_mrope, apply_rope,
                                       decode_attention, ffn_apply,
                                       ffn_defs, rmsnorm, silu)
from repro_torch.sharding.rules import (fence, is_dtensor, local_experts,
                                        settle, shard_reshape)


class Ctx(NamedTuple):
    positions: torch.Tensor           # (B, T) or (B, T, 3) for mrope
    cache_index: int                  # write position for decode
    cache_len: int                    # valid cache length (after write)


# ===========================================================================
# Attention (global or local-window), with optional qk-norm and GQA
# ===========================================================================

def attn_defs(cfg: ModelConfig) -> dict:
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


def _qkv(cfg: ModelConfig, p, x, ctx):
    B, T, _ = x.shape
    q = shard_reshape(x @ p["wq"], B, T, cfg.n_heads, cfg.head_dim)
    k = shard_reshape(x @ p["wk"], B, T, cfg.n_kv_heads, cfg.head_dim)
    v = shard_reshape(x @ p["wv"], B, T, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:                 # per head, before RoPE
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope == "rope":
        q = apply_rope(q, ctx.positions, cfg.rope_theta)
        k = apply_rope(k, ctx.positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = apply_mrope(q, ctx.positions, cfg.rope_theta)
        k = apply_mrope(k, ctx.positions, cfg.rope_theta)
    return q, k, v


def _norm_in(cfg: ModelConfig, p, x, resid):
    """The block's input RMSNorm, of the previous block's fp32 residual sum
    ``resid`` where it hands one over, else of ``x``; rounded to ``x``'s
    dtype."""
    return rmsnorm(x if resid is None else resid, p["norm"],
                   cfg.norm_eps).to(x.dtype)


def _attn_core(cfg: ModelConfig, p, x, ctx, local: bool):
    q, k, v = _qkv(cfg, p, x, ctx)
    window = cfg.attn_window if local else None
    o = L.flash_attention(q, k, v, causal=True, window=window)
    B, T = x.shape[:2]
    return shard_reshape(o, B, T, cfg.d_qkv) @ p["wo"]


def _block(cfg: ModelConfig, p, x, mixer_out, fused: bool = False, ffn=None):
    """The residual adds and the MLP: -> ``(x', resid)``.  ``ffn`` is
    ``(norm scale, fn)`` of what takes the MLP's place (the moe block's
    experts); by default ``p``'s MLP, if it has one.  Unfused every add
    rounds and ``resid`` is None; fused (see the module notes) the MLP
    norm reads the first add's fp32 sum and ``resid`` is the second's, for
    the next block's norm.  ``x'`` is the same either way: a bf16 add
    rounds its fp32 sum.  On DTensors both branches' partial sums are
    reduced before their add (``settle``: tensor parallelism's all-reduce
    per branch; left to DTensor, a reduce-scatter would shard the
    sequence, which later matrix products cannot take)."""
    # a parameter tree's key test reads no tensor
    if ffn is None and "mlp" in p:  # lint: ignore[ts101]
        ffn = (p["mlp_norm"], lambda h: ffn_apply(p["mlp"], h))
    mixer_out = settle(mixer_out)
    if not fused:
        x = x + mixer_out
        if ffn is not None:
            x = x + settle(ffn[1](rmsnorm(x, ffn[0], cfg.norm_eps)))
        return x, None
    s = x.float() + mixer_out.float()
    x = s.to(x.dtype)
    if ffn is not None:
        h = rmsnorm(s, ffn[0], cfg.norm_eps).to(x.dtype)
        s = x.float() + settle(ffn[1](h)).float()
        x = s.to(x.dtype)
    return x, s


def _attn(cfg: ModelConfig, p, x, ctx, local, resid=None, fused=False,
          ffn=None):
    h = _norm_in(cfg, p, x, resid)
    return _block(cfg, p, x, _attn_core(cfg, p, h, ctx, local), fused, ffn)


def attn_apply(cfg: ModelConfig, p, x, ctx, local: bool = False):
    return _attn(cfg, p, x, ctx, local)[0]


class AttnState(NamedTuple):
    k: torch.Tensor    # (B, S, Hkv, Dh) bf16; a ring of S slots if local
    v: torch.Tensor


class QuantAttnState(NamedTuple):
    """int8 KV cache + per-(pos, head) fp32 scales."""
    k: torch.Tensor        # int8 (B, S, Hkv, Dh)
    v: torch.Tensor
    k_scale: torch.Tensor  # fp32 (B, S, Hkv)
    v_scale: torch.Tensor


def kv_quantize(x):
    """Symmetric int8 codes per (position, head) over the head dim: ->
    ``(codes, fp32 scales)``, scale ``max(max |x|, 1e-6) / 127`` and codes
    ``round(x / scale)`` (half to even, as ``jnp.round``) clipped to
    +-127; the divisions are tensor by tensor (CUDA turns a division by a
    host scalar into a product with its reciprocal)."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(-1), 1e-6) / torch.full(
        (), 127.0, device=x.device)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def kv_dequantize(q, s):
    return (q.float() * s[..., None]).to(torch.bfloat16)


def attn_cache_slots(cfg: ModelConfig, cache_len: int,
                     local: bool = False) -> int:
    """A layer's cache slots: ``min(attn_window, cache_len)`` for a local
    layer (a ring), else ``cache_len``."""
    if local and cfg.attn_window:
        return min(cfg.attn_window, cache_len)
    return cache_len


def attn_init_state(cfg: ModelConfig, batch: int, cache_len: int,
                    local: bool = False, device=None):
    """A zero cache of ``S`` slots: ``min(attn_window, cache_len)`` for a
    local layer (a ring), else ``cache_len``; bf16, or int8 codes and fp32
    scales with ``cfg.kv_quant``."""
    S = attn_cache_slots(cfg, cache_len, local)
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
    if cfg.kv_quant:
        return QuantAttnState(k=z(shape, torch.int8), v=z(shape, torch.int8),
                              k_scale=z(shape[:3], torch.float32),
                              v_scale=z(shape[:3], torch.float32))
    return AttnState(k=z(shape, torch.bfloat16), v=z(shape, torch.bfloat16))


def _cache_update_attend(cfg: ModelConfig, q, k, v, state, ctx, local: bool):
    """Write this step's k/v at ``ctx.cache_index`` (``% S`` in a local
    ring; in place; quantised first with ``cfg.kv_quant``) and attend over
    the first ``min(cache_len, S)`` entries."""
    S = state.k.shape[1]
    slot = ctx.cache_index % S if local else ctx.cache_index
    slot = min(max(slot, 0), S - k.shape[1])   # as the JAX clamp
    new = (k, v)
    if cfg.kv_quant:
        (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
        new = (kq, vq, ks, vs)
    for dst, src in zip(state, new):
        dst[:, slot:slot + k.shape[1]] = src.to(dst.dtype)
    if cfg.kv_quant:
        k_cache = kv_dequantize(state.k, state.k_scale)
        v_cache = kv_dequantize(state.v, state.v_scale)
    else:
        k_cache, v_cache = state.k, state.v
    clen = min(ctx.cache_len, S)
    o = decode_attention(q, k_cache, v_cache, clen,
                         window=cfg.attn_window if local else None)
    return o, state


def _attn_decode(cfg: ModelConfig, p, x, state, ctx, local, resid=None,
                 fused=False, ffn=None):
    h = _norm_in(cfg, p, x, resid)
    q, k, v = _qkv(cfg, p, h, ctx)
    o, state = _cache_update_attend(cfg, q, k, v, state, ctx, local)
    B = x.shape[0]
    out = shard_reshape(o, B, 1, cfg.d_qkv) @ p["wo"]
    x, resid = _block(cfg, p, x, out, fused, ffn)
    return x, state, resid


def attn_decode(cfg: ModelConfig, p, x, state, ctx, local: bool = False):
    return _attn_decode(cfg, p, x, state, ctx, local)[:2]


# ===========================================================================
# Mixture of Experts (token-choice top-k, capacity, sort-based dispatch)
# ===========================================================================

def moe_defs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, ff, E = cfg.d_model, m.d_ff_expert, m.num_experts
    defs = {
        "norm": ParamDef((cfg.d_model,), (None,), init="zeros"),
        "router": ParamDef((d, E), ("embed_tp", None)),
        "w_gate": ParamDef((E, d, ff), ("experts", None, "ffn"),
                           fan_in_dims=(-2,)),
        "w_up": ParamDef((E, d, ff), ("experts", None, "ffn"),
                         fan_in_dims=(-2,)),
        "w_down": ParamDef((E, ff, d), ("experts", "ffn", None),
                           fan_in_dims=(-2,)),
    }
    if m.shared_expert:
        defs["shared"] = ffn_defs(d, m.d_ff_expert)
    return defs


MOE_GROUP_SIZE = 256     # tokens per dispatch group (GShard "S")


def top_k(x, k: int):
    """``jax.lax.top_k`` along the last axis: the ``k`` largest values and
    their indices, ties to the lower index (``torch.topk`` breaks them in
    no stated order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: ModelConfig, p, x):
    """fp32 router logits of bf16 inputs -> ``(probs, gate_vals,
    expert_idx)``, the top-k gates renormalised to sum to 1."""
    probs = fence(torch.softmax(x.float() @ p["router"].float(), dim=-1))
    gate_vals, expert_idx = top_k(probs, cfg.moe.top_k)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), expert_idx


def _expert_mlps(p, buf, lead: str):
    """The E SwiGLU experts on their dispatched rows ``buf`` (``lead``
    names its axes before the model dim, the experts ``e`` among them)."""
    up = lambda w: torch.einsum(f"{lead}d,edf->{lead}f", buf, w)
    h = silu(up(p["w_gate"])) * up(p["w_up"])
    return torch.einsum(f"{lead}f,efd->{lead}d", h, p["w_down"])


def gshard_masks(expert_idx, gate_vals, E: int, C: int, dtype):
    """GShard position assignment of top-k choices ``expert_idx`` (G, n,
    k) to ``C`` slots per expert and group: choice slots j = 0..k-1 in
    priority order, tokens in order within each.  -> ``(dispatch (G, n,
    E, C) in dtype, combine (G, n, E, C) fp32 with the gates)``; a token
    past capacity has a zero row in both."""
    G, n, k = expert_idx.shape
    slots = torch.arange(C, device=expert_idx.device)
    dispatch = torch.zeros((G, n, E, C), dtype=dtype,
                           device=expert_idx.device)
    combine = torch.zeros((G, n, E, C), device=expert_idx.device)
    count = torch.zeros((G, 1, E), device=expert_idx.device)  # placed
    for j in range(k):
        mask = F.one_hot(expert_idx[..., j], E).float()
        pos = torch.cumsum(mask, dim=1) - mask + count         # (G, n, E)
        keep = (pos < C) * mask
        count = count + mask.sum(1, keepdim=True)
        oh_c = (pos.long()[..., None] == slots).float()        # (G, n, E, C)
        d_j = keep[..., None] * oh_c
        dispatch = dispatch + d_j.to(dtype)
        combine = combine + d_j * gate_vals[..., j][..., None, None]
    return dispatch, combine


def _gshard_experts(dispatch, combine, xg, w_gate, w_up, w_down):
    """Dispatch ``xg`` (G, n, d) to the (G, E, C) expert slots, run the
    experts, combine back: -> (G, n, d)."""
    buf = torch.einsum("gnec,gnd->gecd", dispatch, xg)         # (G, E, C, d)
    y = _expert_mlps(dict(w_gate=w_gate, w_up=w_up, w_down=w_down), buf,
                     "gec")                                   # (G, E, C, d)
    return torch.einsum("gnec,gecd->gnd", combine, y)


def moe_ffn_grouped(cfg: ModelConfig, p, x):
    """GShard one-hot einsum dispatch over token groups.

    x (B, T, d) is regrouped to (G, n, d) with n = MOE_GROUP_SIZE tokens
    (halved until it divides T); each group routes independently with
    per-group capacity ``C``.  Choice slot ``j`` of every token is placed
    before slot ``j + 1`` of any; a token past capacity gets a zero row
    (``jax.nn.one_hot`` of an out-of-range position).  -> ``(out (B, T,
    d), probs (G * n, E))``."""
    m = cfg.moe
    Bs, T, d = x.shape
    n = min(MOE_GROUP_SIZE, T)
    while T % n:
        n //= 2
    G = Bs * (T // n)
    xg = x.reshape(G, n, d)
    E, k = m.num_experts, m.top_k
    probs, gate_vals, expert_idx = _route(cfg, p, xg)        # (G, n, k)

    C = int(m.capacity_factor * n * k / E + 0.999)
    C = max(1, min(C, n * k))

    dispatch, combine = gshard_masks(expert_idx, gate_vals, E, C, xg.dtype)
    args = (dispatch, combine.to(xg.dtype), xg, p["w_gate"], p["w_up"],
            p["w_down"])
    if is_dtensor(xg):
        out = local_experts(_gshard_experts, *args)
    else:
        out = _gshard_experts(*args)

    out = out.reshape(Bs, T, d)
    if m.shared_expert:
        out = out + ffn_apply(p["shared"], x)
    return out, probs.reshape(G * n, E)


def moe_ffn(cfg: ModelConfig, p, x_flat):
    """Flat sort-based dispatch (``grouped=False``): x_flat (N, d) -> (N,
    d) via top-k routed experts + optional shared, capacity ``C`` per
    expert over all N tokens.

    The reference scatters every (token, choice) row into its expert's
    slot, a dropped one as a zero row into slot ``(E - 1, C - 1)``, and
    XLA applies the scatter in order, the last write winning.  When expert
    ``E - 1`` overflows, its dropped rows come after its kept row at
    ``C - 1`` and zero it.  The port reproduces that deterministically
    (the index of the last writer of each slot, then one gather) where
    ``index_put_`` with repeated indices has no defined order on the card.
    The combine is the reference's bf16 scatter-add, each token's
    contributions added in its sorted order (ascending expert), where
    ``index_add_`` on the card adds in no fixed order."""
    m = cfg.moe
    N, d = x_flat.shape
    E, k = m.num_experts, m.top_k
    dev = x_flat.device
    probs, gate_vals, expert_idx = _route(cfg, p, x_flat)     # (N, k)

    C = int(m.capacity_factor * N * k / E + 0.5)
    C = max(8, min(C, N))

    flat_expert = expert_idx.reshape(-1)                   # (N*k,)
    flat_tok = torch.arange(N, device=dev).repeat_interleave(k)
    flat_gate = gate_vals.reshape(-1)

    order = torch.argsort(flat_expert, stable=True)
    e_sorted = flat_expert[order]
    t_sorted = flat_tok[order]
    g_sorted = flat_gate[order]
    # position within expert segment (a scatter-add count: ``bincount``
    # reads its input's max back to the host on the card)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, e_sorted, torch.ones_like(e_sorted))
    seg_start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * k, device=dev)
    pos = rank - seg_start[e_sorted]
    keep = pos < C                                         # capacity drop
    slot_e = torch.where(keep, e_sorted, E - 1)
    slot_c = torch.where(keep, pos, C - 1)
    slot = slot_e * C + slot_c

    # the reference's in-order scatter: each slot holds its last writer's
    # row (a dropped writer's row is zero); unwritten slots stay zero
    last = torch.full((E * C,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, slot, rank, "amax")
    src = torch.where(keep[:, None], x_flat[t_sorted], 0.0)
    buf = torch.where((last >= 0)[:, None], src[last.clamp_min(0)], 0.0)
    y = _expert_mlps(p, buf.reshape(E, C, d), "ec")       # (E, C, d)

    gathered = y.reshape(E * C, d)[slot]                   # (N*k, d)
    contrib = torch.where(keep[:, None], gathered * g_sorted[:, None], 0.0)
    contrib = contrib.to(x_flat.dtype)
    # each token's k rows in sorted order, added one by one in bf16
    sorted_pos = torch.empty_like(order).scatter_(0, order, rank)
    by_tok = sorted_pos.reshape(N, k).sort(dim=1).values
    out = torch.zeros_like(x_flat)
    for j in range(k):
        out = out + contrib[by_tok[:, j]]
    if m.shared_expert:
        out = out + ffn_apply(p["shared"], x_flat)
    return out, probs


def moe_aux_loss(probs, cfg):
    """Switch-style load-balancing loss over the last router probs."""
    E = cfg.moe.num_experts
    me = probs.mean(0)                                  # mean prob per expert
    ce = F.one_hot(probs.argmax(-1), E).to(probs.dtype).mean(0)
    return E * torch.sum(me * ce)


def _moe_ffn(cfg: ModelConfig, p, h):
    """The grouped or flat dispatch of ``h`` (B, T, d) by ``cfg.moe`` ->
    ``(out (B, T, d), router probs)``."""
    Bs, T, d = h.shape
    if cfg.moe.grouped:
        return moe_ffn_grouped(cfg, p, h)
    out, probs = moe_ffn(cfg, p, h.reshape(Bs * T, d))
    return out.reshape(Bs, T, d), probs


def moe_apply(cfg: ModelConfig, p, x, ctx):
    """The MoE half of the moe block (``p`` its ``"moe"`` tree), op by op:
    ``x + experts(rmsnorm(x))``."""
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    return x + _moe_ffn(cfg, p, h)[0]


def _moe_mlp(cfg: ModelConfig, p, probs: list):
    """The moe block's experts in the MLP's place, for :func:`_block`:
    ``(norm scale, fn)``; fn appends its router probs to ``probs``."""
    def fn(h):
        out, pr = _moe_ffn(cfg, p["moe"], h)
        probs.append(pr)
        return out
    return p["moe"]["norm"], fn


# ===========================================================================
# RG-LRU (recurrentgemma): conv1d(4) + gated linear recurrence
# ===========================================================================
#
# The JAX package runs the recurrence with ``jax.lax.associative_scan``
# (XLA, no Pallas kernel), so the port runs it in plain PyTorch: a
# log-depth scan in fp32.

def rglru_defs(cfg: ModelConfig) -> dict:
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
    # a CPU scalar made from a host float: no device read
    return float(torch.tensor(v, dtype=dtype))  # lint: ignore[ts102]


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation, op for op:
    ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x*x*x))))`` with
    the constants and every op rounded to ``x``'s dtype, as the
    reference's graph computes it (``F.gelu`` rounds once)."""
    dt = x.dtype
    inner = x + _const(0.044715, dt) * (x * x * x)
    th = torch.tanh(_const(math.sqrt(2.0 / math.pi), dt) * inner)
    return x * (_const(0.5, dt) * (1.0 + th))


def _rglru_coeffs(cfg: ModelConfig, p, u):
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


def _rglru(cfg: ModelConfig, p, x, ctx, with_state: bool, resid=None,
           fused=False):
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


def rglru_apply(cfg: ModelConfig, p, x, ctx, with_state: bool = False):
    return _rglru(cfg, p, x, ctx, with_state)[:2]


def rglru_init_state(cfg: ModelConfig, batch: int, cache_len: int,
                     device=None):
    d = cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, d), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, 3, d), dtype=torch.bfloat16, device=device))


def _rglru_decode(cfg: ModelConfig, p, x, state, ctx, resid=None, fused=False):
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


def rglru_decode(cfg: ModelConfig, p, x, state: RGLRUState, ctx):
    return _rglru_decode(cfg, p, x, state, ctx)[:2]


# ===========================================================================
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory) blocks
# ===========================================================================
#
# fp32 inside, as the JAX package.  Prefill steps the cell once per token
# (the reference's ``lax.scan``); a fused recurrence kernel is ROADMAP.md
# queue 1 work.

def mlstm_defs(cfg: ModelConfig) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "norm": ParamDef((d,), (None,), init="zeros"),
        "wq": ParamDef((d, H * hd), ("embed_tp", "qkv")),
        "wk": ParamDef((d, H * hd), ("embed_tp", "qkv")),
        "wv": ParamDef((d, H * hd), ("embed_tp", "qkv")),
        "w_if": ParamDef((d, 2 * H), ("embed_tp", None)),   # i/f gate logits
        "w_o": ParamDef((d, H * hd), ("embed_tp", "qkv")),  # output gate
        "w_out": ParamDef((H * hd, d), ("qkv", "embed_tp")),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor    # (B, H, hd, hd)
    n: torch.Tensor    # (B, H, hd)
    m: torch.Tensor    # (B, H)


def mlstm_init_state(cfg: ModelConfig, batch: int, cache_len: int,
                     device=None):
    H, hd = cfg.n_heads, cfg.head_dim
    z = lambda *shape: torch.zeros(shape, device=device)
    return MLSTMState(C=z(batch, H, hd, hd), n=z(batch, H, hd),
                      m=torch.full((batch, H), -30.0, device=device))


def _mlstm_cell(state: MLSTMState, q, k, v, i_log, f_log):
    """One stabilized mLSTM step.  q/k/v: (B, H, hd); gates: (B, H)."""
    m_new = torch.maximum(f_log + state.m, i_log)
    f_ = torch.exp(f_log + state.m - m_new)[..., None]
    i_ = torch.exp(i_log - m_new)[..., None]
    C = f_[..., None] * state.C + i_[..., None] * (v[..., :, None] *
                                                   k[..., None, :])
    n = f_ * state.n + i_ * k
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q)),
                          torch.exp(-m_new))[..., None]
    h = torch.einsum("bhij,bhj->bhi", C, q) / denom
    return MLSTMState(C=C, n=n, m=m_new), h


def _mlstm_scan(state: MLSTMState, per_token: tuple):
    """The token recurrence over ``per_token = (q, k, v, i_log, f_log)``
    (each ``(B, T, ...)``) -> ``(final state, h (B, T, H, hd))``."""
    hs = []
    for t in range(per_token[0].shape[1]):
        state, h = _mlstm_cell(state, *(x[:, t] for x in per_token))
        hs.append(h)
    return state, torch.stack(hs, 1)


def _mlstm_qkvg(cfg: ModelConfig, p, x):
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    sc = math.sqrt(hd)
    q = shard_reshape(x @ p["wq"], B, T, H, hd).float() / sc
    k = shard_reshape(x @ p["wk"], B, T, H, hd).float() / sc
    v = shard_reshape(x @ p["wv"], B, T, H, hd).float()
    if_log = shard_reshape(x @ p["w_if"], B, T, 2, H).float()
    i_log = if_log[:, :, 0]
    f_log = F.logsigmoid(if_log[:, :, 1] + 1.0)
    o = shard_reshape(torch.sigmoid((x @ p["w_o"]).float()), B, T, H, hd)
    return q, k, v, i_log, f_log, o


def _mlstm(cfg: ModelConfig, p, x, ctx, with_state: bool, resid=None,
           fused=False):
    h0 = _norm_in(cfg, p, x, resid)
    q, k, v, i_log, f_log, o = _mlstm_qkvg(cfg, p, h0)
    B, T = x.shape[:2]
    state = mlstm_init_state(cfg, B, 0, device=x.device)
    state, h = _mlstm_scan(state, (q, k, v, i_log, f_log))
    h = h * o                                        # (B, T, H, hd)
    out = shard_reshape(h, B, T, cfg.d_qkv).to(x.dtype) @ p["w_out"]
    xo, resid = _block(cfg, p, x, out, fused)
    return xo, (state if with_state else None), resid


def mlstm_apply(cfg: ModelConfig, p, x, ctx, with_state: bool = False):
    return _mlstm(cfg, p, x, ctx, with_state)[:2]


def _mlstm_decode(cfg: ModelConfig, p, x, state, ctx, resid=None, fused=False):
    h0 = _norm_in(cfg, p, x, resid)
    q, k, v, i_log, f_log, o = _mlstm_qkvg(cfg, p, h0)
    state, h = _mlstm_cell(state, q[:, 0], k[:, 0], v[:, 0], i_log[:, 0],
                           f_log[:, 0])
    h = h[:, None] * o
    out = shard_reshape(h, x.shape[0], 1, cfg.d_qkv).to(x.dtype) \
        @ p["w_out"]
    x, resid = _block(cfg, p, x, out, fused)
    return x, state, resid


def mlstm_decode(cfg: ModelConfig, p, x, state: MLSTMState, ctx):
    return _mlstm_decode(cfg, p, x, state, ctx)[:2]


def slstm_defs(cfg: ModelConfig) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "norm": ParamDef((d,), (None,), init="zeros"),
        "w_zifo": ParamDef((d, 4 * H * hd), ("embed_tp", "qkv")),
        "r_zifo": ParamDef((H, hd, 4 * hd), (None, None, None)),
        "w_out": ParamDef((H * hd, d), ("qkv", "embed_tp")),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor    # (B, H, hd)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def slstm_init_state(cfg: ModelConfig, batch: int, cache_len: int,
                     device=None):
    H, hd = cfg.n_heads, cfg.head_dim
    z = lambda: torch.zeros((batch, H, hd), device=device)
    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((batch, H, hd), -30.0, device=device))


def _slstm_cell(state: SLSTMState, zifo_x, r):
    """zifo_x: (B, H, 4*hd) input contribution; r: (H, hd, 4*hd)."""
    rec = torch.einsum("bhd,hdk->bhk", state.h, r.float())
    z, i_log, f_log, o = (zifo_x.float() + rec).chunk(4, dim=-1)
    f_log = F.logsigmoid(f_log + 1.0)
    m_new = torch.maximum(f_log + state.m, i_log)
    f_ = torch.exp(f_log + state.m - m_new)
    i_ = torch.exp(i_log - m_new)
    c = f_ * state.c + i_ * torch.tanh(z)
    n = f_ * state.n + i_
    h = torch.sigmoid(o) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(c=c, n=n, h=h, m=m_new), h


def _slstm_scan(state: SLSTMState, per_token: tuple, r):
    """The token recurrence over ``per_token = (zifo,)`` (``(B, T, H, 4
    hd)``) with the recurrent weights ``r`` -> ``(final state, h (B, T, H,
    hd))``."""
    hs = []
    for t in range(per_token[0].shape[1]):
        state, h = _slstm_cell(state, per_token[0][:, t], r)
        hs.append(h)
    return state, torch.stack(hs, 1)


def _slstm(cfg: ModelConfig, p, x, ctx, with_state: bool, resid=None,
           fused=False):
    h0 = _norm_in(cfg, p, x, resid)
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    zifo = shard_reshape(h0 @ p["w_zifo"], B, T, H, 4 * hd)
    r = p["r_zifo"].float()
    state = slstm_init_state(cfg, B, 0, device=x.device)
    state, h = _slstm_scan(state, (zifo,), r)        # h: (B, T, H, hd)
    out = shard_reshape(h, B, T, H * hd).to(x.dtype) @ p["w_out"]
    xo, resid = _block(cfg, p, x, out, fused)
    return xo, (state if with_state else None), resid


def slstm_apply(cfg: ModelConfig, p, x, ctx, with_state: bool = False):
    return _slstm(cfg, p, x, ctx, with_state)[:2]


def _slstm_decode(cfg: ModelConfig, p, x, state, ctx, resid=None, fused=False):
    h0 = _norm_in(cfg, p, x, resid)
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    zifo = shard_reshape(h0 @ p["w_zifo"], B, 1, H, 4 * hd)
    state, h = _slstm_cell(state, zifo[:, 0], p["r_zifo"])
    out = shard_reshape(h, B, 1, H * hd).to(x.dtype) @ p["w_out"]
    x, resid = _block(cfg, p, x, out, fused)
    return x, state, resid


def slstm_decode(cfg: ModelConfig, p, x, state: SLSTMState, ctx):
    return _slstm_decode(cfg, p, x, state, ctx)[:2]


# ===========================================================================
# Block registry
# ===========================================================================

KINDS = ("attn", "local_attn", "moe", "rglru", "mlstm", "slstm")
#: the kinds with an attention layer (and a KV cache): one prefill flash
#: attention call each
ATTN_KINDS = ("attn", "local_attn", "moe")


def _kind(kind: str):
    if kind not in KINDS:
        raise KeyError(kind)


def block_defs(cfg: ModelConfig, kind: str) -> dict:
    _kind(kind)
    if kind == "moe":
        d = attn_defs(cfg)
        d.pop("mlp", None)
        d.pop("mlp_norm", None)
        d["moe"] = moe_defs(cfg)
        return d
    return {"rglru": rglru_defs, "mlstm": mlstm_defs,
            "slstm": slstm_defs}.get(kind, attn_defs)(cfg)


def block_apply(cfg: ModelConfig, kind: str, p, x, ctx,
                with_state: bool = False, *, resid=None,
                fused: bool = False):
    """-> (x', aux_loss, state or None, resid'): attention and moe return
    no state here (the model recomputes their cache, as the JAX package
    does); RG-LRU, mLSTM and sLSTM return their final state when
    ``with_state``; moe's aux loss is :func:`moe_aux_loss` of its router.
    ``fused`` and ``resid``/``resid'`` (the fp32 residual sum handed to
    the next block of a group, None unfused): see the module notes."""
    _kind(kind)
    zero = torch.zeros((), device=x.device)
    if kind == "moe":
        probs = []
        xo, resid = _attn(cfg, p, x, ctx, False, resid, fused,
                          _moe_mlp(cfg, p, probs))
        return xo, moe_aux_loss(probs[0], cfg), None, resid
    if kind in ("rglru", "mlstm", "slstm"):
        run = {"rglru": _rglru, "mlstm": _mlstm, "slstm": _slstm}[kind]
        xo, st, resid = run(cfg, p, x, ctx, with_state, resid, fused)
        return xo, zero, st, resid
    xo, resid = _attn(cfg, p, x, ctx, kind == "local_attn", resid, fused)
    return xo, zero, None, resid


def block_init_state(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     device=None):
    _kind(kind)
    if kind in ("rglru", "mlstm", "slstm"):
        init = {"rglru": rglru_init_state, "mlstm": mlstm_init_state,
                "slstm": slstm_init_state}[kind]
        return init(cfg, batch, cache_len, device=device)
    return attn_init_state(cfg, batch, cache_len,
                           local=kind == "local_attn", device=device)


def block_decode(cfg: ModelConfig, kind: str, p, x, state, ctx, *, resid=None,
                 fused: bool = False):
    """-> (x', state', resid'), ``fused`` and ``resid`` as in
    :func:`block_apply`.  The moe block runs its experts on the one token
    (the grouped dispatch at ``n = 1``: every expert's product is still
    computed, as in the JAX package)."""
    _kind(kind)
    if kind in ("rglru", "mlstm", "slstm"):
        step = {"rglru": _rglru_decode, "mlstm": _mlstm_decode,
                "slstm": _slstm_decode}[kind]
        return step(cfg, p, x, state, ctx, resid, fused)
    ffn = _moe_mlp(cfg, p, []) if kind == "moe" else None
    return _attn_decode(cfg, p, x, state, ctx, kind == "local_attn", resid,
                        fused, ffn)
