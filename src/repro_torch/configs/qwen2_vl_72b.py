"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Backbone only: the vision frontend is a STUB — input_specs() provides
precomputed patch embeddings and M-RoPE (t, h, w) position triples."""
from repro_torch.configs.base import ModelConfig, register_arch

QWEN2_VL_72B = register_arch(ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29_568,
    vocab=152_064, head_dim=128, rope="mrope", rope_theta=1_000_000.0,
    frontend="vision_stub",
))
