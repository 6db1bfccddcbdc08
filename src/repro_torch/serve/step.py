"""Serving steps: prefill (context -> cache + first logits) and decode
(one token against the cache) — the port of ``repro/serve/step.py``.

Decode is eager: one Python iteration per token, each layer's ops
launched one by one (CUDA graphs come later, ROADMAP.md).  On the card
:func:`serve_batch` sets :func:`exact_matmuls` first: fp32 products stay
full fp32 (no TF32) and bf16 products reduce in fp32.
"""
from __future__ import annotations

import time

import torch

from repro_torch import _device
from repro_torch.models.model import (Batch, decode_step, forward,
                                      last_logits)


def exact_matmuls():
    """No TF32 in fp32 products and no reduced-precision reduction in bf16
    products (both are cuBLAS options of the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def make_prefill_step(cfg, cache_len: int):
    def prefill(params, batch: Batch):
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
    ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def serve_batch(cfg, params, prompts, max_new: int, positions=None, *,
                device=None, timings: dict | None = None):
    """Serving loop (prefill + greedy decode).

    prompts: (B, T) int tokens.  Returns ``(tokens (B, max_new), first
    (B,))``: ``first`` is the greedy token of the prefill logits, and
    ``tokens`` the ``max_new`` decoded after it, as the JAX package's
    ``serve_batch``.  Runs on ``device`` (default: the card; ``params``
    must be there).  With a ``timings`` dict it records ``prefill_s`` and
    ``decode_s`` (wall seconds, synchronised with the device)."""
    dev = _device.resolve(device)
    pdev = next(params.parameters()).device
    if pdev.type != dev.type:
        raise ValueError(f"params are on {pdev}, serving on {dev}")
    if dev.type == "cuda":
        exact_matmuls()
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=pdev)
    B, T = prompts.shape[:2]
    S = T + max_new
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=pdev)[None].repeat(B, 1)

    t0 = _sync(pdev)
    prefill = make_prefill_step(cfg, cache_len=S)
    logits, cache = prefill(params, Batch(tokens=prompts,
                                          positions=positions))
    first = greedy_sample(logits[:, -1])
    t1 = _sync(pdev)
    step_fn = make_decode_step(cfg)
    tok, toks = first.reshape(B, 1), []
    for i in range(max_new):
        pos = T + i
        batch = Batch(tokens=tok,
                      positions=torch.full((B, 1), pos, dtype=torch.int32,
                                           device=pdev),
                      cache_index=pos, cache_len=pos + 1)
        logits, cache = step_fn(params, cache, batch)
        nxt = greedy_sample(logits[:, -1])
        toks.append(nxt)
        tok = nxt.reshape(B, 1)
    out = torch.stack(toks, 1) if toks else torch.zeros(
        (B, 0), dtype=torch.int32, device=pdev)
    if timings is not None:
        timings["prefill_s"] = t1 - t0
        timings["decode_s"] = _sync(pdev) - t1
    return out, first
