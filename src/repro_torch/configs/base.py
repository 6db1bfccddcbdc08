"""Model/run configuration schema + architecture registry.

The port's own copy of ``repro/configs/base.py`` (it imports nothing of
the JAX package), with the same ten configurations registered.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False
    capacity_factor: float = 1.25
    grouped: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                   # 0 => block supplies its own projections
    vocab: int
    head_dim: int = 128
    block_pattern: tuple = ("attn",)     # cycled across layers
    attn_window: Optional[int] = None    # local attention window (tokens)
    qk_norm: bool = False
    rope: str = "rope"                   # rope | mrope | none
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    frontend: Optional[str] = None       # vision_stub | audio_stub
    n_codebooks: int = 1                 # audio (EnCodec streams)
    norm_eps: float = 1e-6
    sub_quadratic: bool = False          # may run long_500k decode
    tie_embeddings: bool = False
    d_ff_dense: int = 0                  # dense-layer ffn when != d_ff (llama4)
    kv_quant: bool = False               # int8 KV cache (decode memory lever)
    notes: str = ""

    @property
    def d_qkv(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.head_dim

    def pattern_layers(self) -> list:
        """Per-layer block kinds, block_pattern cycled over n_layers."""
        p = self.block_pattern
        return [p[i % len(p)] for i in range(self.n_layers)]

    def n_groups(self) -> int:
        return self.n_layers // len(self.block_pattern)

    def n_remainder(self) -> int:
        return self.n_layers % len(self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (matches init_params)."""
        from repro_torch.models.model import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared experts only)."""
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)

    def reduced(self, n_layers=None) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        pat = len(self.block_pattern)
        nl = n_layers if n_layers is not None else max(pat, 2 * pat)
        kv = min(self.n_kv_heads, 2)
        heads = max(2, (self.n_heads * 2) // self.n_heads)  # 2 q heads
        heads = max(heads, kv)
        moe = None
        if self.moe:
            # capacity_factor 4.0: tiny smoke shapes must stay drop-free so
            # decode-vs-forward parity is exact
            moe = dataclasses.replace(self.moe, num_experts=4,
                                      top_k=min(self.moe.top_k, 2),
                                      d_ff_expert=64, capacity_factor=4.0)
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=nl, d_model=64,
            n_heads=heads, n_kv_heads=kv, d_ff=128 if self.d_ff else 0,
            vocab=256, head_dim=32, moe=moe,
            attn_window=min(self.attn_window, 64) if self.attn_window else None)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_ARCHS: dict = {}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    _ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401 — ensure registry is populated
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[name]


def all_archs() -> dict:
    import repro_torch.configs  # noqa: F401
    return dict(_ARCHS)


def valid_cells() -> list:
    """All (arch, shape) dry-run cells, honoring the long-context rule."""
    cells = []
    for name, cfg in sorted(all_archs().items()):
        for sname, shape in SHAPES.items():
            if sname == "long_500k" and not cfg.sub_quadratic:
                continue   # only a sub-quadratic arch decodes 500k tokens
            cells.append((name, sname))
    return cells
