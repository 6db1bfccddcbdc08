"""Model assembly: embeddings -> blocks -> head, the port of
``repro/models/model.py`` for the text-only serving path.

The JAX package stacks the repeated block groups and runs them under
``lax.scan`` (with ``jax.checkpoint``); here the parameters hold one tree
per layer (``params["layers"][i]``, layer ``i`` of kind
``cfg.pattern_layers()[i]``) and forward is a Python loop over them, with
no checkpointing at inference.  ``repro_torch.convert`` unstacks the JAX
tree into this one.

Interfaces:
  param_defs(cfg)                      ParamDef tree (shapes)
  init_params(cfg, seed, device)       random params, a ParamTree module
  forward(cfg, params, batch, *, return_states)
                                       -> (final_hidden, aux[, states])
  last_logits(cfg, params, x)          fp32 logits of the last position
  init_cache(cfg, batch, cache_len)    per-layer decode state
  decode_step(cfg, params, cache, batch) -> (logits, cache)

``logits_and_loss`` (training) is not ported yet: ROADMAP.md queue 1
item 13.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch.models import blocks as B
from repro_torch.models.layers import ParamDef, ParamTree, init_tree, rmsnorm


class Batch(NamedTuple):
    """Model inputs (text, no labels yet).  Unused fields are None."""
    tokens: torch.Tensor                # (B, T) int
    positions: torch.Tensor             # (B, T) int
    cache_index: Optional[int] = None   # decode write slot
    cache_len: Optional[int] = None     # valid length after write


def _text_only(cfg):
    if cfg.frontend is not None:
        raise NotImplementedError(f"frontend {cfg.frontend!r} is not ported "
                                  "yet: ROADMAP.md queue 1 item 13")


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------

def param_defs(cfg) -> dict:
    _text_only(cfg)
    d = cfg.d_model
    defs: dict = {"embed": ParamDef((cfg.vocab, d), ("vocab", "embed_tp"))}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((d, cfg.vocab), (None, "vocab"))
    defs["final_norm"] = ParamDef((d,), (None,), init="zeros")
    defs["layers"] = [B.block_defs(cfg, kind)
                      for kind in cfg.pattern_layers()]
    return defs


def init_params(cfg, seed: int = 0, device=None) -> ParamTree:
    """Random bf16 parameters on ``device`` (default: the card), drawn
    from a ``torch.Generator`` on that device seeded with ``seed``."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return init_tree(gen, param_defs(cfg), dev)


def count_params(cfg) -> int:
    """Parameter count from the shapes of :func:`param_defs` (nothing is
    allocated)."""
    def walk(defs):
        items = defs if isinstance(defs, list) else defs.values()
        return sum(walk(v) if isinstance(v, (dict, list))
                   else int(np.prod(v.shape)) for v in items)
    return walk(param_defs(cfg))


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_input(cfg, params, batch: Batch):
    _text_only(cfg)
    return F.embedding(batch.tokens, params["embed"])      # (B, T, D)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def forward(cfg, params, batch: Batch, *, return_states: bool = False,
            cache_len: int | None = None):
    x = embed_input(cfg, params, batch)
    ctx = B.Ctx(positions=batch.positions, cache_index=0, cache_len=0)
    aux = torch.zeros((), device=x.device)
    states = []
    for kind, p in zip(cfg.pattern_layers(), params["layers"]):
        x, a, st = _apply_with_state(cfg, kind, p, x, ctx, return_states,
                                     cache_len)
        aux = aux + a
        states.append(st)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_states:
        return x, aux, states
    return x, aux


def _apply_with_state(cfg, kind, p, x, ctx, return_states, cache_len):
    xin = x
    x, aux, st = B.block_apply(cfg, kind, p, x, ctx)
    if return_states:
        # attention caches are recomputed k/v of the prefix
        st = _prefill_attn_state(cfg, p, ctx, xin, cache_len)
    return x, aux, st


def _prefill_attn_state(cfg, p, ctx, x, cache_len):
    """Recompute k/v for the prefix and lay them into a bf16 decode cache
    of ``cache_len`` positions (the last ``cache_len`` if the prefix is
    longer)."""
    if cache_len is None:
        raise ValueError("return_states needs cache_len")
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    _, k, v = B._qkv(cfg, p, h, ctx)
    T = x.shape[1]
    st = B.attn_init_state(cfg, x.shape[0], cache_len, device=x.device)
    n = min(T, cache_len)
    st.k[:, :n] = k[:, T - n:].to(st.k.dtype)
    st.v[:, :n] = v[:, T - n:].to(st.v.dtype)
    return st


# ---------------------------------------------------------------------------
# Head
# ---------------------------------------------------------------------------

def _unembed(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].t()          # (V, D) -> (D, V)
    return params["unembed"]


def last_logits(cfg, params, x):
    """fp32 logits of the final position, (B, 1, V): a full-fp32 product
    (``torch.matmul``; TF32 must be off on the card)."""
    return x[:, -1:].float() @ _unembed(cfg, params).float()


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, cache_len: int, device=None) -> list:
    dev = _device.resolve(device)
    return [B.block_init_state(cfg, kind, batch, cache_len, device=dev)
            for kind in cfg.pattern_layers()]


def decode_step(cfg, params, cache: list, batch: Batch):
    """One token for every sequence in the batch.  tokens: (B, 1).  The
    cache is updated in place and returned."""
    x = embed_input(cfg, params, batch)
    ctx = B.Ctx(positions=batch.positions, cache_index=int(batch.cache_index),
                cache_len=int(batch.cache_len))
    new_cache = []
    for kind, p, st in zip(cfg.pattern_layers(), params["layers"], cache):
        x, st = B.block_decode(cfg, kind, p, x, st, ctx)
        new_cache.append(st)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return last_logits(cfg, params, x), new_cache
