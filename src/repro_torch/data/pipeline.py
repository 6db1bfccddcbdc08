"""Synthetic LM data pipeline: deterministic, shardable, restart-safe, the
port of ``repro/data/pipeline.py``.

Batches are a pure function of ``(seed, step, shard)``, the property the
fault-tolerance layer relies on: any host can regenerate any step's batch
after a restart.  The random numbers come from an explicit host
generator, ``numpy.random.Generator(PCG64(SeedSequence((seed, step,
shard))))``, and the batch is then moved to the device, so a CPU run and
a card run see the same batches.  They are not ``jax.random``'s bits:
:func:`zipf_bigram_tokens` is the reference's transform of the uniforms
and the coin, and equals it bit for bit when fed the reference's draws.

Token streams follow a Zipf-ish marginal with a bigram twist (with
probability 1/2 a token is ``(prev * 31 + 7) % V`` of its left
neighbour), so the loss decreases during the example training runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import VIS_FRAC, Batch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


def zipf_bigram_tokens(u: np.ndarray, coin: np.ndarray, vocab: int,
                       zipf_a: float) -> np.ndarray:
    """The reference's ``_tokens`` transform: uniforms ``u`` in [1e-6, 1)
    (fp32) -> Zipf ranks ``floor(exp(log(u) / (1 - a)) - 1)`` clipped to
    the vocabulary; where ``coin``, the bigram successor ``(base * 31 +
    7) % V`` of the token before it along the LAST axis (``roll`` by 1,
    wrapping: for the audio stub's ``(b, T + 1, K)`` draws that axis is
    the codebooks, a quirk of the reference kept here).  int32."""
    u = np.asarray(u, np.float32)
    ranks = np.floor(np.exp(np.log(u) / np.float32(1.0 - zipf_a))
                     - np.float32(1.0))
    base = np.clip(ranks, 0, vocab - 1).astype(np.int32)
    nxt = (base * 31 + 7) % vocab
    shifted = np.roll(nxt, 1, axis=-1)
    return np.where(coin, shifted, base).astype(np.int32)


def _generator(dc: DataConfig, step: int, shard: int):
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        (int(dc.seed), int(step), int(shard)))))


def make_batch(cfg: ModelConfig, dc: DataConfig, step: int,
               shard: int = 0, n_shards: int = 1, device=None) -> Batch:
    """Batch for one step (optionally one data shard of it) on ``device``
    (default: the card): tokens and labels ``(b, T)`` (``(b, T, K)`` for
    the audio stub) from ``b, T + 1`` draws, text positions (M-RoPE's
    ``(p, p // 7, p % 7)``), and for the vision stub ``(b, T // VIS_FRAC,
    d_model)`` bf16 patch embeddings, a unit normal times 0.02."""
    dev = _device.resolve(device)
    b, T = dc.global_batch // n_shards, dc.seq_len
    rng = _generator(dc, step, shard)
    shape = (b, T + 1) + ((cfg.n_codebooks,)
                          if cfg.frontend == "audio_stub" else ())
    u = np.maximum(rng.random(shape, dtype=np.float32)
                   * np.float32(1.0 - 1e-6) + np.float32(1e-6),
                   np.float32(1e-6))
    coin = rng.random(shape) < 0.5
    toks = torch.from_numpy(zipf_bigram_tokens(u, coin, cfg.vocab,
                                               dc.zipf_a)).to(dev)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None].repeat(b, 1)
    if cfg.rope == "mrope":
        pos = torch.stack([pos, pos // 7, pos % 7], dim=-1)
    vis = None
    if cfg.frontend == "vision_stub":
        z = rng.standard_normal((b, T // VIS_FRAC, cfg.d_model),
                                dtype=np.float32)
        vis = (torch.from_numpy(z).to(torch.bfloat16)
               * torch.tensor(0.02, dtype=torch.bfloat16)).to(dev)
    return Batch(tokens=tokens, positions=pos, labels=labels,
                 vis_embeds=vis)


def synthetic_stream(cfg: ModelConfig, dc: DataConfig, start_step: int = 0,
                     device=None):
    step = start_step
    while True:
        yield step, make_batch(cfg, dc, step, device=device)
        step += 1
