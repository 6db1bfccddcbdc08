"""Token traffic: the zipf-bigram stream, drawn on the device.

The transform is the program's synthetic pipeline's (a Zipf-ish marginal,
and with probability 1/2 a token is the bigram successor ``(prev * 31 +
7) % V`` of the draw before it), copied here so that the yardstick does
not move with the program.  The uniforms come from a ``torch.Generator``
on the device, so a batch costs a few kernel launches and no host copy.
"""
from __future__ import annotations

from yardstick import seeds


def zipf_bigram(gen, shape, vocab: int, zipf_a: float, device):
    """int32 tokens of ``shape`` in ``[0, vocab)``: uniforms ``u`` in
    ``[1e-6, 1)`` -> ranks ``floor(u ** (1 / (1 - a)) - 1)`` clipped to the
    vocabulary; where a fair coin falls, the bigram successor of the draw
    one place to the left along the last axis (wrapping)."""
    import torch
    u = torch.rand(shape, generator=gen, device=device) * (1.0 - 1e-6) + 1e-6
    coin = torch.rand(shape, generator=gen, device=device) < 0.5
    ranks = torch.floor(torch.exp(torch.log(u) / (1.0 - zipf_a)) - 1.0)
    base = ranks.clamp(0, vocab - 1).to(torch.int64)
    shifted = torch.roll((base * 31 + 7) % vocab, 1, dims=-1)
    return torch.where(coin, shifted, base).to(torch.int32)


def train_rows(seed: int, step: int, batch: int, seq: int, vocab: int,
               zipf_a: float, device):
    """``(tokens, labels)``, each ``(batch, seq)`` int32, of training step
    ``step`` (counted from 1): ``batch`` rows of ``seq + 1`` draws, every
    row its own."""
    gen = seeds.generator(device, seed, "train_rows", step)
    toks = zipf_bigram(gen, (batch, seq + 1), vocab, zipf_a, device)
    return toks[:, :-1].contiguous(), toks[:, 1:].contiguous()


def prompt(seed: int, index: int, length: int, vocab: int, zipf_a: float,
           device):
    """Prompt ``index`` of a run: ``(1, length)`` int32."""
    gen = seeds.generator(device, seed, "prompt", index)
    return zipf_bigram(gen, (1, length), vocab, zipf_a, device)
