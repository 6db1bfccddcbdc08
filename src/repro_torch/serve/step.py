"""Serving steps: prefill (context -> cache + first logits) and decode
(one token against the cache) — the port of ``repro/serve/step.py``.

Decode is eager: one Python iteration per token, each layer's ops
launched one by one (CUDA graphs come later, ROADMAP.md).  On the card
:func:`serve_batch` sets :func:`exact_matmuls` first: fp32 products stay
full fp32 (no TF32) and bf16 products reduce in fp32.
"""
from __future__ import annotations

import itertools
import time

import torch

from repro_torch import _device
from repro_torch.models.model import (Batch, decode_step, forward,
                                      last_logits)
from repro_torch.telemetry import spans


def exact_matmuls():
    """No TF32 in fp32 products and no reduced-precision reduction in bf16
    products (both are cuBLAS options of the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def make_prefill_step(cfg, cache_len: int):
    """``prefill(params, batch) -> (last logits, decode states)``.  Its
    spans (``repro_torch.telemetry.spans``) share the id ``request`` (the
    call's number in this closure, from 0), and so do those of the
    :func:`greedy_sample` that follows it."""
    requests = itertools.count()

    def prefill(params, batch: Batch):
        spans.tag(request=next(requests))
        x, _aux, states = forward(cfg, params, batch, return_states=True,
                                  cache_len=cache_len)
        return last_logits(cfg, params, x), states
    return prefill


def make_decode_step(cfg):
    def step(params, cache, batch: Batch):
        return decode_step(cfg, params, cache, batch)
    return step


def greedy_sample(logits):
    """argmax over the last axis; ties go to the first index, as
    ``jnp.argmax``.  Records span ``serve.sample``."""
    with spans.span("serve.sample"):
        return torch.argmax(logits, dim=-1).to(torch.int32)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def mrope_positions(pos):
    """Text positions ``pos`` (any shape) as M-RoPE's (t, h, w) triples
    ``(p, p // 7, p % 7)``, stacked on a new last axis (the JAX package's
    ``serve_batch``)."""
    return torch.stack([pos, pos // 7, pos % 7], -1)


def serve_batch(cfg, params, prompts, max_new: int, positions=None, *,
                device=None, timings: dict | None = None):
    """Serving loop (prefill + greedy decode).

    prompts: (B, T) int tokens, or (B, T, K) for an audio config.  Returns
    ``(tokens (B, max_new[, K]), first (B[, K]))``: ``first`` is the
    greedy token of the prefill logits, and ``tokens`` the ``max_new``
    decoded after it, as the JAX package's ``serve_batch``.  An M-RoPE
    config gets the positions ``(p, p // 7, p % 7)``.  Runs on ``device``
    (default: the card; ``params`` must be there).  With a ``timings``
    dict it records ``prefill_s`` and ``decode_s`` (wall seconds,
    synchronised with the device); without one it does not synchronise."""
    dev = _device.resolve(device)
    pdev = next(params.parameters()).device
    if pdev.type != dev.type:
        raise ValueError(f"params are on {pdev}, serving on {dev}")
    if dev.type == "cuda":
        exact_matmuls()
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=pdev)
    B, T = prompts.shape[:2]
    S = T + max_new
    mrope = cfg.rope == "mrope"
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=pdev)[None].repeat(B, 1)
        if mrope:
            positions = mrope_positions(positions)

    t0 = _sync(pdev) if timings is not None else None
    prefill = make_prefill_step(cfg, cache_len=S)
    logits, cache = prefill(params, Batch(tokens=prompts,
                                          positions=positions))
    first = greedy_sample(logits[:, -1])        # (B,) or (B, K) for audio
    t1 = _sync(pdev) if timings is not None else None
    step_fn = make_decode_step(cfg)
    tok, toks = first[:, None], []
    for i in range(max_new):
        pos = torch.full((B, 1), T + i, dtype=torch.int32, device=pdev)
        batch = Batch(tokens=tok,
                      positions=mrope_positions(pos) if mrope else pos,
                      cache_index=T + i, cache_len=T + i + 1)
        logits, cache = step_fn(params, cache, batch)
        nxt = greedy_sample(logits[:, -1])
        toks.append(nxt)
        tok = nxt[:, None]
    out = torch.stack(toks, 1) if toks else torch.zeros(
        (B, 0) + tuple(first.shape[1:]), dtype=torch.int32, device=pdev)
    if timings is not None:
        timings["prefill_s"] = t1 - t0
        timings["decode_s"] = _sync(pdev) - t1
    return out, first
