"""Model assembly: embeddings/frontend stubs -> blocks -> head, the port
of ``repro/models/model.py``.

The JAX package stacks the repeated block groups and runs them under
``lax.scan`` with ``jax.checkpoint`` on the scan body; here the
parameters hold one tree per layer (``params["layers"][i]``, layer ``i``
of kind ``cfg.pattern_layers()[i]``) and forward is a Python loop over
them.  In training (grad enabled, trainable parameters) each repeated
group of ``cfg.block_pattern`` runs under ``torch.utils.checkpoint``
(non-reentrant), the reference's remat per group; the remainder layers
are not checkpointed, as there.  Prefill and decode checkpoint nothing.
Under ``torch.profiler`` the steps record the spans of
``repro_torch.telemetry.spans``: ``lm.group.fwd``, ``.recompute`` and
``.bwd`` per group, ``lm.head.fwd`` per chunk and ``lm.head.bwd`` in
training; ``lm.layer.fwd`` and ``lm.prefill.kv_state`` per layer and
``lm.last_logits`` in prefill.
``repro_torch.convert`` unstacks the JAX tree into this one.

Interfaces:
  param_defs(cfg)                      ParamDef tree (shapes)
  init_params(cfg, seed, device)       random params, a ParamTree module
  forward(cfg, params, batch, *, return_states)
                                       -> (final_hidden, aux[, states])
  logits_and_loss(cfg, params, batch)  chunked-vocab xent (train objective)
  last_logits(cfg, params, x)          fp32 logits of the last position
  init_cache(cfg, batch, cache_len)    per-layer decode state
  decode_step(cfg, params, cache, batch) -> (logits, cache)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import loss_head as LH
from repro_torch.models import blocks as B
from repro_torch.models.layers import ParamDef, ParamTree, init_tree, rmsnorm
from repro_torch.sharding.rules import is_dtensor, settle
from repro_torch.telemetry import spans


VIS_FRAC = 8      # vision stub: first T/VIS_FRAC positions are patch embeds


class Batch(NamedTuple):
    """Model inputs.  Unused fields are None."""
    tokens: torch.Tensor                # (B, T) int or (B, T, K) audio
    positions: torch.Tensor             # (B, T) or (B, T, 3) for mrope
    labels: Optional[torch.Tensor] = None       # like tokens; -1: no loss
    vis_embeds: Optional[torch.Tensor] = None   # (B, T//VIS_FRAC, D)
    cache_index: Optional[int] = None   # decode write slot
    cache_len: Optional[int] = None     # valid length after write


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------

def param_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    defs: dict = {}
    if cfg.frontend == "audio_stub":
        defs["embed"] = ParamDef((cfg.n_codebooks, cfg.vocab, d),
                                 (None, "vocab", None))
        if not cfg.tie_embeddings:
            defs["unembed"] = ParamDef((cfg.n_codebooks, d, cfg.vocab),
                                       (None, None, "vocab"))
    else:
        defs["embed"] = ParamDef((cfg.vocab, d), ("vocab", "embed_tp"))
        if not cfg.tie_embeddings:
            defs["unembed"] = ParamDef((d, cfg.vocab), (None, "vocab"))
    defs["final_norm"] = ParamDef((d,), (None,), init="zeros")
    defs["layers"] = [B.block_defs(cfg, kind)
                      for kind in cfg.pattern_layers()]
    return defs


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> ParamTree:
    """Random bf16 parameters on ``device`` (default: the card), drawn
    from a ``torch.Generator`` on that device seeded with ``seed``."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return init_tree(gen, param_defs(cfg), dev)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the shapes of :func:`param_defs` (nothing is
    allocated).  ``active_only``: an expert leaf (``w_gate``, ``w_up``,
    ``w_down`` under a ``moe`` tree, the shared expert's included, as the
    JAX package counts) counts ``top_k / num_experts`` of its size."""
    def walk(defs, path=()):
        items = enumerate(defs) if isinstance(defs, list) else defs.items()
        total = 0
        for k, v in items:
            if isinstance(v, (dict, list)):
                total += walk(v, path + (k,))
                continue
            n = int(np.prod(v.shape))
            if active_only and cfg.moe and "moe" in path and \
                    k in ("w_gate", "w_up", "w_down"):
                n = n * cfg.moe.top_k // cfg.moe.num_experts
            total += n
        return total
    return walk(param_defs(cfg))


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_input(cfg: ModelConfig, params, batch: Batch):
    """Token embeddings (B, T, D).  Audio: tokens (B, T, K), the K
    codebook embeddings summed in codebook order, each add in bf16.
    Vision: ``batch.vis_embeds`` (B, nv, D), if given, overwrite the first
    nv positions."""
    if cfg.frontend == "audio_stub":
        embeds = params["embed"]                       # (K, V, D)
        x = settle(F.embedding(batch.tokens[..., 0], embeds[0]))
        for k in range(1, cfg.n_codebooks):
            x = x + settle(F.embedding(batch.tokens[..., k], embeds[k]))
    else:
        x = F.embedding(batch.tokens, params["embed"])     # (B, T, D)
    x = settle(x)
    if cfg.frontend == "vision_stub" and batch.vis_embeds is not None:
        nv = batch.vis_embeds.shape[1]
        x = torch.cat([batch.vis_embeds.to(x.dtype), x[:, nv:]], dim=1)
    return x


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, batch: Batch, *,
            return_states: bool = False, cache_len: int | None = None):
    """-> ``(final_hidden, aux[, states])``.  In training (grad enabled,
    trainable parameters, no ``return_states``) each repeated layer group
    runs under ``torch.utils.checkpoint``: its activations are recomputed
    in the backward pass.  A group hands no fp32 residual to the next
    (``_group_step``), so the boundaries fall where the reference's scan
    carry is rounded."""
    x = embed_input(cfg, params, batch)
    ctx = B.Ctx(positions=batch.positions, cache_index=0, cache_len=0)
    aux = torch.zeros((), device=x.device)
    kinds = cfg.pattern_layers()
    if (not return_states and torch.is_grad_enabled()
            and params["final_norm"].requires_grad):
        P, G = len(cfg.block_pattern), cfg.n_groups()
        for g in range(G):
            x, a = _group(g, x, lambda x: checkpoint(
                _run_layers, cfg, params, range(g * P, (g + 1) * P), x, ctx,
                use_reentrant=False))
            aux = aux + a
        rest = range(G * P, len(kinds))
        run = lambda x: _run_layers(cfg, params, rest, x, ctx)
        x, a = _group(G, x, run) if rest else run(x)
        aux = aux + a
        return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux
    states, resid = [], None
    for i, (kind, p) in enumerate(zip(kinds, params["layers"])):
        fused, resid = _group_step(cfg, i, resid)
        x, a, st, resid = _apply_with_state(cfg, kind, p, x, ctx,
                                            return_states, cache_len,
                                            resid, fused, layer=i)
        aux = aux + a
        states.append(st)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_states:
        return x, aux, states
    return x, aux


def _group(g: int, x, run):
    """``run(x) -> (x, aux)`` as layer group ``g`` of a training forward:
    span ``lm.group.fwd`` around it, and ``lm.group.bwd`` from the
    gradient at its output to the gradient at its input."""
    with spans.span("lm.group.fwd", group=g):
        x, a = run(spans.bwd_close(x, "lm.group.bwd"))
        return spans.bwd_open(x, "lm.group.bwd", group=g), a


def _run_layers(cfg: ModelConfig, params, layers: range, x, ctx):
    """Layers ``layers`` (one group, or the remainder) from ``x`` with no
    residual handed in -> ``(x, their aux loss sum)``.  Run again in the
    backward pass (a checkpointed group's recompute), it records span
    ``lm.group.recompute``."""
    aux, resid = torch.zeros((), device=x.device), None
    kinds = cfg.pattern_layers()
    with (spans.span("lm.group.recompute",
                     group=layers.start // len(cfg.block_pattern))
          if spans.in_backward() else spans.OFF):
        for i in layers:
            fused, resid = _group_step(cfg, i, resid)
            x, a, _, resid = B.block_apply(cfg, kinds[i],
                                           params["layers"][i], x, ctx,
                                           resid=resid, fused=fused)
            aux = aux + a
    return x, aux


def _group_step(cfg: ModelConfig, i: int, resid):
    """Layer ``i``'s rounding (``blocks`` module notes): ``(fused, the
    residual sum it reads)``.  Layers of the reference's scanned groups
    (the first ``n_groups * len(block_pattern)``) are fused, and read the
    previous block's fp32 sum unless they start a group (the scan's carry
    is rounded); the remainder layers run op by op."""
    P = len(cfg.block_pattern)
    fused = i < cfg.n_groups() * P
    return fused, resid if fused and i % P else None


def _apply_with_state(cfg: ModelConfig, kind: str, p, x, ctx,
                      return_states: bool, cache_len, resid=None,
                      fused=False, layer: int | None = None):
    """One block; with ``return_states`` also its decode state by kind:
    an attention (or moe) cache is recomputed k/v of the prefix
    (ring-aligned for a local layer), RG-LRU, mLSTM and sLSTM return their
    own final state."""
    xin, rin = x, resid
    with spans.span("lm.layer.fwd", layer=layer):
        x, aux, st, resid = B.block_apply(cfg, kind, p, x, ctx,
                                          with_state=return_states,
                                          resid=resid, fused=fused)
    if return_states and kind in B.ATTN_KINDS:
        with spans.span("lm.prefill.kv_state", layer=layer):
            st = _prefill_attn_state(cfg, p, ctx, xin, cache_len,
                                     local=kind == "local_attn", resid=rin)
    return x, aux, st, resid


def _prefill_attn_state(cfg: ModelConfig, p, ctx, x, cache_len,
                        local: bool = False, resid=None):
    """Recompute k/v for the prefix and lay them into a decode cache of
    ``S`` slots (``B.attn_cache_slots``; quantised to int8 with
    ``cfg.kv_quant``).  A prefix of ``T >= S`` tokens keeps its last
    ``S``: in slots ``0..S-1`` for a global cache, at slots ``arange(T -
    S, T) % S`` of a local ring (where decode's ``index % S`` will find
    them)."""
    if cache_len is None:
        raise ValueError("return_states needs cache_len")
    h = B._norm_in(cfg, p, x, resid)
    _, k, v = B._qkv(cfg, p, h, ctx)
    T = x.shape[1]
    S = B.attn_cache_slots(cfg, cache_len, local)
    if T >= S:
        # position T - S + i goes to slot (T - S + i) % S: a roll by T % S
        shift = T % S if local else 0
        k, v = (t[:, T - S:] for t in (k, v))
        if shift:
            k, v = (torch.roll(t, shift, dims=1) for t in (k, v))
    # the first T slots hold the prefix, the rest zeros (a padded copy:
    # a sharded k/v stays sharded alike; a full cache is the prefix)
    pad = lambda t: t if t.shape[1] == S else F.pad(
        t, (0, 0) * (t.dim() - 2) + (0, S - t.shape[1]))
    if cfg.kv_quant:
        (kq, ks), (vq, vs) = B.kv_quantize(k), B.kv_quantize(v)
        return B.QuantAttnState(*(pad(t) for t in (kq, vq, ks, vs)))
    return B.AttnState(*(pad(t.to(torch.bfloat16)) for t in (k, v)))


# ---------------------------------------------------------------------------
# Loss head (vocab-chunked cross entropy)
# ---------------------------------------------------------------------------

def logits_and_loss(cfg: ModelConfig, params, batch: Batch,
                    seq_chunk: int = 512):
    """Mean next-token cross entropy over the labels that are not -1, and
    the aux loss: the sequence (padded to a multiple of ``seq_chunk`` with
    label -1) goes through the head ``seq_chunk`` positions at a time, so
    only one chunk's fp32 logits exist at once in the forward pass (on the
    bf16 route in the backward too: none are saved)."""
    x, aux = forward(cfg, params, batch)
    x = spans.bwd_close(x, "lm.head.bwd")
    labels = batch.labels
    T = x.shape[1]
    seq_chunk = min(seq_chunk, T)
    Tp = -(-T // seq_chunk) * seq_chunk
    xpad, lpad = x, labels
    if Tp > T:
        xpad = F.pad(x, (0, 0, 0, Tp - T))
        lpad = F.pad(labels, (0, 0) * (labels.dim() - 2) + (0, Tp - T),
                     value=-1)
    w = _unembed(cfg, params)
    bf16 = _bf16_head(x, w)
    if not bf16:
        w = w.float()       # once, not once a chunk (autograd keeps each)
    sums, counts = [], []
    for c in range(0, Tp, seq_chunk):
        with spans.span("lm.head.fwd", chunk=c // seq_chunk):
            s, n = _xent(cfg, w, xpad[:, c:c + seq_chunk],
                         lpad[:, c:c + seq_chunk], bf16)
        sums.append(s)
        counts.append(n)
    total = torch.stack(sums).sum() / torch.clamp_min(
        torch.stack(counts).sum(), 1)
    return spans.bwd_open(total, "lm.head.bwd"), aux


def _bf16_head(x, w) -> bool:
    """Whether the head takes ``kernels.loss_head`` (bf16 products with
    fp32 sums, the logits recomputed in the backward): plain bf16 tensors
    on one device, on the card or the CPU.  fp32 operands (the exact split
    of the logits' gradient needs bf16 ones) and DTensors (a vocab-sharded
    head's logsumexp crosses shards) take :func:`_xent_eager`."""
    return (not is_dtensor(x) and not is_dtensor(w)
            and x.dtype == w.dtype == torch.bfloat16
            and x.device == w.device)


def _xent(cfg: ModelConfig, w, x, labels, bf16: bool):
    """x: (B, C, D) against the head ``w`` (:func:`_unembed`); labels (B,
    C) or (B, C, K).  Returns (nll sum, count).  ``bf16`` (from
    :func:`_bf16_head`): ``kernels.loss_head``, the audio stub's ``(K, D,
    V)`` head one codebook after the other; else :func:`_xent_eager`, ``w``
    already fp32."""
    mask = labels >= 0
    if not bf16:
        return _xent_eager(cfg, w, x, labels), mask.sum()
    xs = x.reshape(-1, x.shape[-1])
    nll = LH.loss_head(xs, w, labels.reshape(xs.shape[0], *labels.shape[2:]))
    return nll.sum(), mask.sum()


def _xent_eager(cfg: ModelConfig, w, x, labels):
    """The nll sum of :func:`_xent` as the reference writes it: fp32
    logits against the fp32 head ``w``, logsumexp, the true label's logit,
    masked where the label is negative (TF32 must be off on the card)."""
    if cfg.frontend == "audio_stub":
        lg = _codebook_logits(x.float(), w)
    else:
        lg = torch.einsum("bcd,dv->bcv", x.float(), w)
    lse = torch.logsumexp(lg, dim=-1)
    mask = labels >= 0
    safe = labels.clamp_min(0).long()
    true_lg = settle(torch.gather(lg, -1, safe[..., None]))[..., 0]
    nll = torch.where(mask, lse - true_lg, torch.zeros_like(lse))
    return nll.sum()


# ---------------------------------------------------------------------------
# Head
# ---------------------------------------------------------------------------

def _unembed(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        # (V, D) -> (D, V); audio (K, V, D) -> (K, D, V)
        return params["embed"].transpose(-1, -2)
    return params["unembed"]


def _codebook_logits(x, w):
    """``(B, T, D) x (K, D, V) -> (B, T, K, V)``: one einsum, or on
    DTensors one product per codebook (DTensor cannot run the einsum's
    merged (K, V) product with V sharded)."""
    if is_dtensor(x):
        return torch.stack([x @ w[k] for k in range(w.shape[0])], 2)
    return torch.einsum("btd,kdv->btkv", x, w)


def last_logits(cfg: ModelConfig, params, x):
    """fp32 logits of the final position, (B, 1, V), or (B, 1, K, V) for
    audio (one head per codebook): a full-fp32 product (TF32 must be off
    on the card)."""
    with spans.span("lm.last_logits"):
        xl, w = x[:, -1:].float(), _unembed(cfg, params).float()
        if cfg.frontend == "audio_stub":
            return _codebook_logits(xl, w)
        return xl @ w


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device=None) -> list:
    dev = _device.resolve(device)
    return [B.block_init_state(cfg, kind, batch, cache_len, device=dev)
            for kind in cfg.pattern_layers()]


def decode_step(cfg: ModelConfig, params, cache: list, batch: Batch):
    """One token for every sequence in the batch.  tokens: (B, 1), or (B,
    1, K) for audio.  The attention caches are updated in place; the
    recurrent states are new tensors.  -> ``(logits, cache)``."""
    x = embed_input(cfg, params, batch)
    ctx = B.Ctx(positions=batch.positions, cache_index=int(batch.cache_index),
                cache_len=int(batch.cache_len))
    new_cache, resid = [], None
    for i, (kind, p, st) in enumerate(zip(cfg.pattern_layers(),
                                          params["layers"], cache)):
        fused, resid = _group_step(cfg, i, resid)
        x, st, resid = B.block_decode(cfg, kind, p, x, st, ctx, resid=resid,
                                      fused=fused)
        new_cache.append(st)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return last_logits(cfg, params, x), new_cache
