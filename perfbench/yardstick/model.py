"""A configuration file's model, and its weights made from the seed.

A file under ``configs/`` holds the published config's keys with the
values as run, and ``model_keys``, which names the key that gives each of
the harness's sizes (``model_fixed`` gives those the published config
does not state as a key, and the program's model family).  Its
``reference`` names the plain reference, ``reference/<name>.py``, that
the drivers load.  :func:`load` reads it into a :class:`Dense`.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

from yardstick import seeds

ROOT = Path(__file__).resolve().parents[1]
SIZES = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
         "vocab", "norm_eps", "rope_theta", "qk_norm", "tie_embeddings")


@dataclasses.dataclass(frozen=True)
class Dense:
    """A dense GQA transformer: RMSNorm, RoPE over the whole head (halves
    rotated), optional per-head qk-norm, causal attention, SwiGLU MLP."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    norm_eps: float
    rope_theta: float
    qk_norm: bool
    tie_embeddings: bool
    family: str = "dense"
    reference: str = "dense_gqa"

    @property
    def d_q(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.head_dim


def load(name: str) -> Dense:
    raw = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    vals = {k: raw[key] for k, key in raw["model_keys"].items()}
    vals.update(raw.get("model_fixed", {}))
    missing = set(SIZES) - set(vals)
    if missing:
        raise ValueError(f"config {name}: no value for {sorted(missing)}")
    return Dense(name=name, family=vals.get("family", "dense"),
                 reference=raw["reference"], **{k: vals[k] for k in SIZES})


def weight_kinds(m: Dense) -> dict:
    """``{kind: (shape, init)}``; a per-layer kind's shape leads with
    ``n_layers``.  ``init`` is the standard deviation of a normal draw:
    ``1/sqrt(fan_in)`` for a product's weight, 0.1 for a norm's scale
    (stored as its offset from 1)."""
    L, d = m.n_layers, m.d_model
    std = lambda fan_in: 1.0 / math.sqrt(fan_in)
    kinds = {"embed": ((m.vocab, d), std(d)),
             "final_norm": ((d,), 0.1),
             "attn_norm": ((L, d), 0.1),
             "wq": ((L, d, m.d_q), std(d)),
             "wk": ((L, d, m.d_kv), std(d)),
             "wv": ((L, d, m.d_kv), std(d)),
             "wo": ((L, m.d_q, d), std(m.d_q)),
             "mlp_norm": ((L, d), 0.1),
             "w_gate": ((L, d, m.d_ff), std(d)),
             "w_up": ((L, d, m.d_ff), std(d)),
             "w_down": ((L, m.d_ff, d), std(m.d_ff))}
    if m.qk_norm:
        kinds["q_norm"] = ((L, m.head_dim), 0.1)
        kinds["k_norm"] = ((L, m.head_dim), 0.1)
    if not m.tie_embeddings:
        kinds["unembed"] = ((d, m.vocab), std(d))
    return kinds


def make_weight(m: Dense, seed: int, kind: str, device):
    """One kind's bf16 tensor, drawn on ``device`` from its own stream of
    ``seed``: any kind can be made again alone, with the same values."""
    import torch
    shape, sd = weight_kinds(m)[kind]
    gen = seeds.generator(device, seed, "weight", kind)
    w = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.bfloat16)
    return w.mul_(sd)


def make_weights(m: Dense, seed: int, device) -> dict:
    """Every kind: ``{kind: tensor}``, one draw per kind."""
    return {k: make_weight(m, seed, k, device) for k in weight_kinds(m)}


LAYER_LEAVES = {"attn_norm": "norm", "wq": "wq", "wk": "wk", "wv": "wv",
                "wo": "wo", "q_norm": "q_norm", "k_norm": "k_norm",
                "mlp_norm": "mlp_norm", "w_gate": "mlp.w_gate",
                "w_up": "mlp.w_up", "w_down": "mlp.w_down"}


def leaf_names(m: Dense) -> dict:
    """``{program leaf name: (kind, layer or None)}``: where each leaf of
    the program's parameter tree comes from."""
    out = {}
    for kind in weight_kinds(m):
        if kind in LAYER_LEAVES:
            for i in range(m.n_layers):
                out[f"layers.{i}.{LAYER_LEAVES[kind]}"] = (kind, i)
        else:
            out[kind] = (kind, None)
    return out


def program_leaves(m: Dense, weights: dict) -> dict:
    """The program's leaves as views of the stacked kinds (no copy)."""
    return {name: weights[k] if i is None else weights[k][i]
            for name, (k, i) in leaf_names(m).items()}
