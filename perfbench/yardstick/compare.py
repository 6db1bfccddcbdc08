"""The numbers that decide ``correct``, each against its limit.

Training compares the first step's loss, the per-leaf norms of the first
step's gradient as the optimizer got it, and the per-leaf norms of the
parameters' change after the checked steps.  The later steps' losses are
reported beside them: after Adam's first step, which moves every weight
by the learning rate times the sign of its gradient, they carry the
rounding of the signs of near-zero gradients and swing from seed to
seed.  A leaf's norms are compared by their gap over the reference's
norm of that leaf or of the median leaf, whichever is larger (some
gradients are all but zero).
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone and are left out of the
change.

Prefill compares, for each checked prompt, how far the served token's
reference logit lies below the reference's best, the relative error of
the last position's logits, and the relative error of each layer's cache.
The cache is compared through a sketch: a fixed matrix of random signs,
drawn from the seed, sums its positions into ``SKETCH_ROWS`` rows.  The
sketch of a difference is the difference of the sketches.  It keeps the
norm of a difference confined to a few positions exactly, and of one
spread over the cache to about a percent, so the program's cache need
not stay on the card until the reference has run.
"""
from __future__ import annotations

import math

from yardstick import seeds

ROUNDOFF_LEAF = 1e-3
SKETCH_ROWS = 128


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def leaf_gap(prog, ref, keep=None) -> float:
    """The worst leaf's ``|prog - ref| / max(ref, median ref)``, over the
    leaves ``keep`` lets in (all when None)."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    if not idx:
        return 0.0
    med = _median([ref[i] for i in idx])
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``{"loss": [...], "grad": [...], "delta":
    [...]}`` (per-leaf lists in one order)."""
    g_ref = list(map(float, ref["grad"]))
    med = _median(g_ref)
    keep = [g >= ROUNDOFF_LEAF * med for g in g_ref]
    steps = [abs(a - b) for a, b in zip(prog["loss"], ref["loss"])]
    return {
        "loss_gap": steps[0],
        **{f"loss_gap.step{i}": g for i, g in enumerate(steps[1:], 2)},
        "grad_gap": leaf_gap(list(map(float, prog["grad"])), g_ref),
        "delta_gap": leaf_gap(list(map(float, prog["delta"])),
                              list(map(float, ref["delta"])), keep),
    }


def rel_err(a, b) -> float:
    """``|a - b| / |b|`` (fp32 norms of two tensors)."""
    d = (a.float() - b.float()).norm()
    return float(d / b.float().norm().clamp_min(1e-30))


def sketch_matrix(seed: int, positions: int, device):
    """The ``(SKETCH_ROWS, positions)`` matrix of random signs of ``seed``
    (float64)."""
    import torch
    gen = seeds.generator(device, seed, "kv sketch")
    r = torch.randint(0, 2, (SKETCH_ROWS, positions), generator=gen,
                      device=device)
    return r.to(torch.float64).mul_(2).sub_(1)


def sketch(signs, t):
    """``signs @ t`` over positions, in float64: ``t (B, T, ...)`` as
    ``(B*T, rest)``; -> ``(SKETCH_ROWS, rest)``."""
    flat = t.reshape(t.shape[0] * t.shape[1], -1)
    return signs @ flat.to(signs.device, signs.dtype)


def token_gap(ref_logits, token: int) -> float:
    """How far the reference's logit of ``token`` lies below its best."""
    return float(ref_logits.max() - ref_logits[token])


def judge(numbers: dict, limits: dict) -> tuple:
    """-> ``(correct, {name: {"value", "limit"}})``: correct when every
    number is finite and at or under its limit, and every limit has its
    number."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
