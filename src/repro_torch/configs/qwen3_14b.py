"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].
40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936."""
from repro_torch.configs.base import ModelConfig, register_arch

QWEN3_14B = register_arch(ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=17_408,
    vocab=151_936, head_dim=128, qk_norm=True, rope="rope",
    rope_theta=1_000_000.0,
    notes="40 heads % 16 != 0: head TP falls back to qkv-dim sharding "
          "(sharding/rules.py).",
))
