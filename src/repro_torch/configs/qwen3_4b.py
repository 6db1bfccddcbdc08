"""qwen3-4b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].
36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936."""
from repro_torch.configs.base import ModelConfig, register_arch

QWEN3_4B = register_arch(ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab=151_936, head_dim=128, qk_norm=True, rope="rope",
    rope_theta=1_000_000.0,
))
