"""Sub-seeds of a run's ``--seed``: one independent stream per purpose."""
from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` under ``seed``: the
    same arguments give the same number on every machine."""
    text = repr((int(seed),) + tuple(tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags):
    """A ``torch.Generator`` on ``device`` seeded with ``derive(seed,
    *tags)``."""
    import torch
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))
